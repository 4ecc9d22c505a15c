"""Assigned input shapes and per-cell input specs (PyTorch port of
``repro.configs.shapes``).

Four shapes per architecture (40 nominal cells):
  train_4k     seq 4096  x global_batch 256   -> train_step
  prefill_32k  seq 32768 x global_batch 32    -> serve_step (prefill)
  decode_32k   one token against a 32768 KV context, batch 128 -> serve_step
  long_500k    one token against a 524288 context, batch 1     -> serve_step

Skips:
  - decode shapes for encoder-only archs (no autoregressive step)
  - long_500k for pure full-attention archs (needs sub-quadratic context)

``input_specs`` returns shape-and-dtype stand-ins on the ``meta`` device
(no storage) where the reference returns ``jax.ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def applicable(model_cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped) for one (arch, shape) cell."""
    if shape.kind == "decode" and not model_cfg.causal:
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and model_cfg.family not in ("ssm",
                                                              "hybrid"):
        return False, "full quadratic attention: 512k context infeasible"
    if shape.name == "long_500k" and not model_cfg.causal:
        return False, "encoder-only: no autoregressive decode step"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch(cfg, shape: ShapeSpec,
                 batch_override: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
    B = batch_override or shape.global_batch
    S = shape.seq_len
    out: Dict[str, torch.Tensor] = {}
    if cfg.input_mode == "frames":
        out["frames"] = _meta((B, S, cfg.frame_dim), torch.bfloat16)
        out["labels"] = _meta((B, S), torch.int32)
    else:
        out["tokens"] = _meta((B, S), torch.int32)
    if cfg.family == "vlm":
        out["image_embeds"] = _meta((B, cfg.num_vision_tokens, cfg.d_model),
                                    torch.bfloat16)
    return out


def input_specs(cfg, shape: ShapeSpec, *,
                batch_override: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for the *batch* inputs of one cell.

    Decode cells additionally need a decode state, built separately
    (``launch.shardings.decode_state_sds``) because its structure depends
    on the model plan.
    """
    if shape.kind in ("train", "prefill"):
        return _token_batch(cfg, shape, batch_override)
    # decode: one new token
    B = batch_override or shape.global_batch
    return {"tokens": _meta((B, 1), torch.int32)}


def batch_axes(cfg, shape: ShapeSpec) -> Dict[str, str]:
    """'|'-encoded logical axes per batch input (see backbone.parse_axes)."""
    if shape.kind == "decode":
        return {"tokens": "batch|"}
    out = {}
    if cfg.input_mode == "frames":
        out["frames"] = "batch||"
        out["labels"] = "batch|"
    else:
        out["tokens"] = "batch|"
    if cfg.family == "vlm":
        out["image_embeds"] = "batch|vision|"
    return out
