"""Multi-family model backbone with prefill / decode / encode APIs
(PyTorch).

The counterpart of ``repro.models.backbone`` for the dense, SSM, audio and
hybrid families.  A model is a *layer plan*

    prefix kinds  +  (pattern kinds) x n_groups  +  suffix kinds

with kinds ``attn`` (pre-norm GQA self-attention, + MLP when d_ff > 0),
``ssd`` (Mamba-2 SSD block: norm + ssd, no MLP) and ``rec`` (RG-LRU block
+ MLP).  The kinds ``moe`` and ``cross`` (the MoE and vision families) are
not ported yet.  Where the JAX package scans stacked group parameters, the
port keeps the layers as one Python list in execution order (the prefix,
then group by group, pattern position by pattern position, then the
suffix), and the decode state as one cache entry per layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models import attention, common, ffn, mamba2, rglru
from repro_torch.models.attention import KVCache
from repro_torch.models.common import Params, Spec

VOCAB_ALIGN = 128  # the reference pads the vocab to a multiple of this


def padded_vocab(cfg) -> int:
    v = cfg.vocab_size
    return -(-v // VOCAB_ALIGN) * VOCAB_ALIGN


# ----------------------------------------------------------------- layer plan
NEXT_SLICE = "moe and cross layers (MoE and vision families) come with the " \
    "next slice of the port"


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    prefix: Tuple[str, ...]
    pattern: Tuple[str, ...]
    n_groups: int
    suffix: Tuple[str, ...]

    @property
    def kinds(self) -> Tuple[str, ...]:
        """Every layer's kind, in execution order."""
        return self.prefix + self.pattern * self.n_groups + self.suffix


def layer_plan(cfg) -> LayerPlan:
    if cfg.family == "ssm":
        pattern: Tuple[str, ...] = ("ssd",)
    elif cfg.family == "hybrid":
        pattern = tuple(cfg.block_pattern) or ("rec", "rec", "attn")
    elif cfg.family in ("dense", "audio"):
        pattern = ("attn",)
    else:
        raise ValueError(f"family {cfg.family!r}: {NEXT_SLICE}")
    for kind in set(pattern) & {"moe", "cross"}:
        raise ValueError(f"layer kind {kind!r}: {NEXT_SLICE}")
    prefix = ("attn",) * cfg.first_dense_layers
    body = cfg.num_layers - len(prefix)
    n_groups = body // len(pattern)
    suffix = pattern[: body % len(pattern)]
    return LayerPlan(prefix, pattern, n_groups, suffix)


# ------------------------------------------------------------------ specs
def _norm_spec(cfg) -> Spec:
    return Spec((cfg.d_model,), "ones")


def block_specs(kind: str, cfg) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    if kind == "ssd":
        return {"ln": _norm_spec(cfg), "ssd": mamba2.ssd_specs(cfg)}
    if kind == "rec":
        return {"ln1": _norm_spec(cfg), "rglru": rglru.rglru_specs(cfg),
                "ln2": _norm_spec(cfg), "mlp": ffn.mlp_specs(D, F)}
    if kind == "attn":
        s = {"ln1": _norm_spec(cfg),
             "attn": attention.attn_specs(D, cfg.num_heads,
                                          cfg.num_kv_heads, cfg.head_dim,
                                          cfg.use_bias, cfg.qk_norm)}
        if F > 0:
            s["ln2"] = _norm_spec(cfg)
            s["mlp"] = ffn.mlp_specs(D, F, cfg.use_bias, cfg.mlp_gated)
        return s
    raise ValueError(kind)


def model_specs(cfg) -> dict:
    Vp = padded_vocab(cfg)
    if cfg.input_mode == "frames":
        embed = {"frame_proj": Spec((cfg.frame_dim, cfg.d_model)),
                 "frame_bias": Spec((cfg.d_model,), "zeros")}
    else:
        embed = {"tok": Spec((Vp, cfg.d_model), "embed")}
    s = {"embed": embed,
         "layers": [block_specs(k, cfg) for k in layer_plan(cfg).kinds],
         "final_norm": _norm_spec(cfg)}
    if cfg.input_mode == "frames" or not cfg.tie_embeddings:
        s["head"] = Spec((cfg.d_model, Vp))    # untied
    return s


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Params:
    """Random weights drawn from ``gen`` (a generator on ``device``)."""
    return Params(common.init_tree(model_specs(cfg), gen, dtype,
                                   device if device is not None
                                   else gen.device))


def count_params(cfg) -> int:
    return common.count_params(model_specs(cfg))


# ------------------------------------------------------------------ forward
def _embed(params, cfg, inputs, compute_dtype):
    """Token ids [B, S] or, for frame input, frames [B, S, frame_dim]."""
    if cfg.input_mode == "frames":
        e = params["embed"]
        x = torch.matmul(inputs.to(compute_dtype),
                         e["frame_proj"].to(compute_dtype)) \
            + e["frame_bias"].to(compute_dtype)
    else:
        x = params["embed"]["tok"][inputs].to(compute_dtype)
    if cfg.scale_embeddings:
        # sqrt(d_model) rounded to the compute dtype, as a Python scalar:
        # no host-to-device copy (and its stream sync) per call
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype)
        x = x * scale.item()
    return x


def _attn_kwargs(cfg) -> dict:
    return dict(rope_theta=cfg.rope_theta, window=cfg.attn_window,
                softcap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
                norm_eps=cfg.norm_eps,
                use_rope=cfg.causal)    # the encoder (hubert) skips rope


def apply_block(kind: str, p, x, cfg, positions, *,
                collect_cache: bool = False):
    """One layer forward.  Returns (x, cache_entry_or_None)."""
    cache = None
    if kind == "ssd":
        h = common.rms_norm(x, p["ln"], cfg.norm_eps)
        out = mamba2.ssd_block(p["ssd"], h, cfg, return_state=collect_cache)
    else:
        h = common.rms_norm(x, p["ln1"], cfg.norm_eps)
        if kind == "rec":
            out = rglru.rglru_block(p["rglru"], h, cfg,
                                    return_state=collect_cache)
        elif kind == "attn":
            out = attention.self_attention(
                p["attn"], h, positions, causal=cfg.causal,
                return_kv=collect_cache, **_attn_kwargs(cfg))
        else:
            raise ValueError(kind)
    if collect_cache:
        out, cache = out
    x = x + out
    if "mlp" in p:              # rec, and attn when d_ff > 0
        h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + ffn.mlp(p["mlp"], h)
    return x, cache


def forward_hidden(params, cfg, inputs, *, compute_dtype=torch.bfloat16):
    """Embed + all layers + final norm.  inputs: tokens [B, S] (frames
    [B, S, frame_dim] for frame input) -> [B, S, D]."""
    x = _embed(params, cfg, inputs, compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for kind, p in zip(layer_plan(cfg).kinds, params["layers"]):
        x, _ = apply_block(kind, p, x, cfg, positions)
    return common.rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_from_hidden(params, cfg, x) -> torch.Tensor:
    """Full-vocab logits, from the untied head or the tied embedding.
    [B, S, D] -> [B, S, Vp] float32."""
    if "head" in params:
        w = params["head"].to(x.dtype)
    else:
        w = params["embed"]["tok"].to(x.dtype).T
    logits = torch.matmul(x, w).float()
    Vp = logits.shape[-1]
    if Vp > cfg.vocab_size:  # mask vocab padding
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# ------------------------------------------------------------------ decode
class DecodeState(NamedTuple):
    pos: int             # number of tokens already in context
    layers: tuple        # one cache entry per layer (KVCache / SSMState /
    #                      RGLRUState)


def _attn_cache_len(cfg, max_len: int) -> int:
    window = cfg.attn_window
    if window > 0:
        return min(window, max_len)
    return max_len


def init_block_cache(kind: str, cfg, batch: int, max_len: int, dtype,
                     device):
    if kind == "ssd":
        return mamba2.ssd_init_state(cfg, batch, dtype, device)
    if kind == "rec":
        return rglru.rglru_init_state(cfg, batch, dtype, device)
    if kind == "attn":
        return KVCache.zeros(batch, _attn_cache_len(cfg, max_len),
                             cfg.num_kv_heads, cfg.head_dim, dtype, device)
    raise ValueError(kind)


def init_decode_state(cfg, batch: int, max_len: int, dtype,
                      device) -> DecodeState:
    return DecodeState(pos=0, layers=tuple(
        init_block_cache(k, cfg, batch, max_len, dtype, device)
        for k in layer_plan(cfg).kinds))


def decode_block(kind: str, p, cache, x, cfg, pos: int):
    """One layer of single-token decode.  Returns (x, new_cache)."""
    if kind == "ssd":
        h = common.rms_norm(x, p["ln"], cfg.norm_eps)
        out, cache = mamba2.ssd_decode_step(p["ssd"], h, cache, cfg)
        return x + out, cache
    h = common.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "rec":
        out, cache = rglru.rglru_decode_step(p["rglru"], h, cache, cfg)
    elif kind == "attn":
        out, cache = attention.decode_self_attention(
            p["attn"], h, cache, pos, **_attn_kwargs(cfg))
    else:
        raise ValueError(kind)
    x = x + out
    if "mlp" in p:
        h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + ffn.mlp(p["mlp"], h)
    return x, cache


def decode_step(params, cfg, state: DecodeState, token: torch.Tensor, *,
                compute_dtype=torch.bfloat16):
    """One decode step.  token: [B, 1] -> ([B, Vp] f32 logits, state).

    The attention caches are updated in place.
    """
    x = _embed(params, cfg, token, compute_dtype)
    caches = []
    for kind, p, c in zip(layer_plan(cfg).kinds, params["layers"],
                          state.layers):
        x, c = decode_block(kind, p, c, x, cfg, state.pos)
        caches.append(c)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, x)[:, 0]
    return logits, DecodeState(pos=state.pos + 1, layers=tuple(caches))


# ------------------------------------------------------------------ prefill
def _fill_kv_cache(cfg, kv, max_len: int, dtype) -> KVCache:
    """Place prefill K/V [B, S, Kh, D] into a (possibly ring) cache: the
    last min(S, L) tokens, token t in slot t % L."""
    k, v = kv
    B, S = k.shape[:2]
    L = _attn_cache_len(cfg, max_len)
    cache = KVCache.zeros(B, L, cfg.num_kv_heads, cfg.head_dim, dtype,
                          k.device)
    take = min(S, L)
    ts = torch.arange(S - take, S, device=k.device)
    slots = ts % L if cfg.attn_window > 0 else ts
    cache.k[:, slots] = k[:, ts].to(dtype)
    cache.v[:, slots] = v[:, ts].to(dtype)
    return cache


def prefill(params, cfg, tokens, *, max_len: Optional[int] = None,
            compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16):
    """Process the prompt [B, S]; return ([B, Vp] f32 last-position logits,
    DecodeState)."""
    x = _embed(params, cfg, tokens, compute_dtype)
    S = x.shape[1]
    max_len = max_len or S
    positions = torch.arange(S, device=x.device)
    caches = []
    for kind, p in zip(layer_plan(cfg).kinds, params["layers"]):
        x, c = apply_block(kind, p, x, cfg, positions, collect_cache=True)
        if kind == "attn":
            c = _fill_kv_cache(cfg, c, max_len, cache_dtype)
        caches.append(c)
    x = common.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, x)[:, 0]
    return logits, DecodeState(pos=S, layers=tuple(caches))


def encode(params, cfg, frames, *, compute_dtype=torch.bfloat16):
    """Encoder-only serve step (hubert): frames [B, S, frame_dim] ->
    full-sequence logits [B, S, Vp] float32."""
    x = forward_hidden(params, cfg, frames, compute_dtype=compute_dtype)
    return logits_from_hidden(params, cfg, x)
