"""Architecture / run configuration schema and registry (PyTorch port).

A copy of ``repro.configs.base`` (plain Python, copied so that the port
imports nothing of ``repro``), cut to what the serving path of the hybrid
family reads: ``ModelConfig`` keeps the JAX names and defaults of those
fields, and ``RunConfig`` holds the model alone (the training settings
come back with the training code).  The registry lists only the
architecture the port serves; the other architectures of the JAX package
are not ported yet and ``load_config`` refuses them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # hybrid: the one family the port serves
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # transformer flags (the port refuses the ones RecurrentGemma leaves off)
    qk_norm: bool = False
    use_bias: bool = False
    tie_embeddings: bool = False
    causal: bool = True            # False => encoder-only (no decode path)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    attn_window: int = 0           # 0 = global attention
    attn_softcap: float = 0.0
    # hybrid (recurrentgemma): repeating block pattern
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    rglru_conv_width: int = 4
    rglru_expand: int = 1          # lru width = expand * d_model (RG uses 1)
    input_mode: str = "tokens"     # tokens | frames
    scale_embeddings: bool = False # gemma-style sqrt(d_model) embed scaling
    mlp_gated: bool = True         # SwiGLU (True) vs GELU MLP (False)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig


ARCH_IDS = ["recurrentgemma-2b"]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"repro_torch serves only {ARCH_IDS}; {arch_id!r} "
                         f"is not ported yet")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def load_config(arch_id: str) -> RunConfig:
    return _module(arch_id).get_config()


def load_smoke_config(arch_id: str) -> RunConfig:
    return _module(arch_id).get_smoke_config()
