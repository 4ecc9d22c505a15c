"""Hybrid (RecurrentGemma) backbone with prefill / decode APIs (PyTorch).

The counterpart of ``repro.models.backbone`` for the ``hybrid`` family.  A
model is a *layer plan*

    (pattern kinds) x n_groups  +  suffix kinds

with kinds ``rec`` (RG-LRU block + MLP) and ``attn`` (local GQA attention
+ MLP).  Where the JAX package scans stacked group parameters, the port
keeps the layers as one Python list in execution order (group by group,
pattern position by pattern position, then the suffix), and the decode
state as one cache entry per layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models import attention, common, ffn, rglru
from repro_torch.models.attention import KVCache
from repro_torch.models.common import Params, Spec

VOCAB_ALIGN = 128  # the reference pads the vocab to a multiple of this


def padded_vocab(cfg) -> int:
    v = cfg.vocab_size
    return -(-v // VOCAB_ALIGN) * VOCAB_ALIGN


# ----------------------------------------------------------------- layer plan
@dataclasses.dataclass(frozen=True)
class LayerPlan:
    pattern: Tuple[str, ...]
    n_groups: int
    suffix: Tuple[str, ...]

    @property
    def kinds(self) -> Tuple[str, ...]:
        """Every layer's kind, in execution order."""
        return self.pattern * self.n_groups + self.suffix


def layer_plan(cfg) -> LayerPlan:
    if cfg.family != "hybrid":
        raise ValueError(f"repro_torch ports the hybrid family only, not "
                         f"{cfg.family!r}")
    pattern = tuple(cfg.block_pattern) or ("rec", "rec", "attn")
    n_groups = cfg.num_layers // len(pattern)
    suffix = pattern[: cfg.num_layers % len(pattern)]
    return LayerPlan(pattern, n_groups, suffix)


# ------------------------------------------------------------------ specs
def _norm_spec(cfg) -> Spec:
    return Spec((cfg.d_model,), "ones")


def block_specs(kind: str, cfg) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    if kind == "rec":
        return {"ln1": _norm_spec(cfg), "rglru": rglru.rglru_specs(cfg),
                "ln2": _norm_spec(cfg), "mlp": ffn.mlp_specs(D, F)}
    if kind == "attn":
        return {"ln1": _norm_spec(cfg),
                "attn": attention.attn_specs(D, cfg.num_heads,
                                             cfg.num_kv_heads, cfg.head_dim),
                "ln2": _norm_spec(cfg), "mlp": ffn.mlp_specs(D, F)}
    raise ValueError(kind)


def model_specs(cfg) -> dict:
    if not cfg.tie_embeddings or cfg.input_mode != "tokens" \
            or cfg.use_bias or cfg.qk_norm or cfg.d_ff <= 0 \
            or not cfg.mlp_gated or not cfg.causal:
        raise ValueError(f"{cfg.name}: the port's hybrid path takes tied "
                         f"token embeddings, a gated MLP, causal attention "
                         f"and no biases or qk-norm")
    return {"embed": {"tok": Spec((padded_vocab(cfg), cfg.d_model),
                                  "embed")},
            "layers": [block_specs(k, cfg) for k in layer_plan(cfg).kinds],
            "final_norm": _norm_spec(cfg)}


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Params:
    """Random weights drawn from ``gen`` (a generator on ``device``)."""
    return Params(common.init_tree(model_specs(cfg), gen, dtype,
                                   device if device is not None
                                   else gen.device))


def count_params(cfg) -> int:
    return common.count_params(model_specs(cfg))


# ------------------------------------------------------------------ forward
def _embed(params, cfg, tokens, compute_dtype):
    x = params["embed"]["tok"][tokens].to(compute_dtype)
    if cfg.scale_embeddings:
        # sqrt(d_model) rounded to the compute dtype, as a Python scalar:
        # no host-to-device copy (and its stream sync) per call
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype)
        x = x * scale.item()
    return x


def apply_block(kind: str, p, x, cfg, positions, *,
                collect_cache: bool = False):
    """One layer forward.  Returns (x, cache_entry_or_None)."""
    cache = None
    h = common.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "rec":
        out = rglru.rglru_block(p["rglru"], h, cfg,
                                return_state=collect_cache)
    elif kind == "attn":
        out = attention.self_attention(
            p["attn"], h, positions, rope_theta=cfg.rope_theta,
            causal=cfg.causal, window=cfg.attn_window,
            softcap=cfg.attn_softcap, return_kv=collect_cache)
    else:
        raise ValueError(kind)
    if collect_cache:
        out, cache = out
    x = x + out
    h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn.mlp(p["mlp"], h), cache


def forward_hidden(params, cfg, tokens, *, compute_dtype=torch.bfloat16):
    """Embed + all layers + final norm.  tokens [B, S] -> [B, S, D]."""
    x = _embed(params, cfg, tokens, compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for kind, p in zip(layer_plan(cfg).kinds, params["layers"]):
        x, _ = apply_block(kind, p, x, cfg, positions)
    return common.rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_from_hidden(params, cfg, x) -> torch.Tensor:
    """Tied-embedding logits.  [B, S, D] -> [B, S, Vp] float32."""
    w = params["embed"]["tok"]
    logits = torch.matmul(x, w.to(x.dtype).T).float()
    Vp = logits.shape[-1]
    if Vp > cfg.vocab_size:  # mask vocab padding
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# ------------------------------------------------------------------ decode
class DecodeState(NamedTuple):
    pos: int             # number of tokens already in context
    layers: tuple        # one cache entry per layer (KVCache / RGLRUState)


def _attn_cache_len(cfg, max_len: int) -> int:
    window = cfg.attn_window
    if window > 0:
        return min(window, max_len)
    return max_len


def init_block_cache(kind: str, cfg, batch: int, max_len: int, dtype,
                     device):
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
    h = common.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "rec":
        out, cache = rglru.rglru_decode_step(p["rglru"], h, cache, cfg)
    elif kind == "attn":
        out, cache = attention.decode_self_attention(
            p["attn"], h, cache, pos, rope_theta=cfg.rope_theta,
            window=cfg.attn_window, softcap=cfg.attn_softcap)
    else:
        raise ValueError(kind)
    x = x + out
    h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn.mlp(p["mlp"], h), cache


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
