"""GQA attention (PyTorch): the flash prefill of self- and cross-attention,
and the one-token decode over a full-length cache, the ring buffer of
local attention or the static memory of cross-attention.

The counterpart of ``repro.models.attention``, with its optional biases,
qk-norm and (for the encoder and cross-attention) no RoPE.  The prefill
runs ``ops.flash_attention`` (the hand-written CUDA kernel on the card)
where the JAX package runs ``chunked_attention``: global causal for the
dense and MoE families, local for the hybrid one, non-causal for the
encoder and for cross-attention over the vision memory (Sq queries over
Skv = ``num_vision_tokens`` keys).  The one-token decode attends over the
whole cache in plain torch, as ``chunked_attention`` does for a single
query block in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import Spec, shard

NEG_INF = -1e30


def attn_specs(d_model: int, num_heads: int, num_kv_heads: int,
               head_dim: int, use_bias: bool = False,
               qk_norm: bool = False) -> dict:
    s = {
        "wq": Spec((d_model, num_heads, head_dim),
                   ("embed", "heads", None)),
        "wk": Spec((d_model, num_kv_heads, head_dim),
                   ("embed", "kv_heads", None)),
        "wv": Spec((d_model, num_kv_heads, head_dim),
                   ("embed", "kv_heads", None)),
        "wo": Spec((num_heads, head_dim, d_model),
                   ("heads", None, "embed"), fan_in=num_heads * head_dim),
    }
    if use_bias:
        s["bq"] = Spec((num_heads, head_dim), ("heads", None), "zeros")
        s["bk"] = Spec((num_kv_heads, head_dim), ("kv_heads", None),
                       "zeros")
        s["bv"] = Spec((num_kv_heads, head_dim), ("kv_heads", None),
                       "zeros")
        s["bo"] = Spec((d_model,), ("embed",), "zeros")
    if qk_norm:
        s["q_norm"] = Spec((head_dim,), ("head_dim",), "ones")
        s["k_norm"] = Spec((head_dim,), ("head_dim",), "ones")
    return s


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, Kh, D]
    v: torch.Tensor  # [B, S_max, Kh, D]

    @staticmethod
    def zeros(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
              dtype, device) -> "KVCache":
        shp = (batch, max_len, num_kv_heads, head_dim)
        return KVCache(torch.zeros(shp, dtype=dtype, device=device),
                       torch.zeros(shp, dtype=dtype, device=device))


def _in_proj(x, w):
    """x [B, S, D] by w [D, H, K] -> [B, S, H, K] (one matrix product, as
    the einsum "bsd,dhk->bshk")."""
    return torch.matmul(x, w.to(x.dtype).flatten(1)).unflatten(
        -1, w.shape[1:])


def _project_q(p, x, qk_norm, norm_eps):
    q = _in_proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    if qk_norm:
        q = common.rms_norm(q, p["q_norm"], norm_eps)
    return q


def cross_kv(p, kv_src, *, qk_norm=False, norm_eps=1e-6):
    """Project the memory (the vision tokens) [B, Nv, D_model] to K/V
    [B, Nv, Kh, D] once; the decode reuses them.  Also the K/V of
    self-attention, where the memory is the input itself."""
    k = _in_proj(kv_src, p["wk"])
    v = _in_proj(kv_src, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(kv_src.dtype)
        v = v + p["bv"].to(kv_src.dtype)
    if qk_norm:
        k = common.rms_norm(k, p["k_norm"], norm_eps)
    return k, v


def _project_qkv(p, x, qk_norm, norm_eps):
    k, v = cross_kv(p, x, qk_norm=qk_norm, norm_eps=norm_eps)
    return _project_q(p, x, qk_norm, norm_eps), k, v


def _project_out(p, out, x):
    out = torch.matmul(out.flatten(2), p["wo"].to(x.dtype).flatten(0, 1))
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return shard(out, "batch", "seq", None)


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> contiguous [B, H, S, D] (the kernel's layout)."""
    return x.transpose(1, 2).contiguous()


def self_attention(p, x, positions, *, rope_theta, causal=True, window=0,
                   softcap=0.0, qk_norm=False, norm_eps=1e-6, use_rope=True,
                   return_kv=False):
    """Prefill self-attention.  x: [B, S, D_model], positions: [S]."""
    q, k, v = _project_qkv(p, x, qk_norm, norm_eps)
    if use_rope:
        q = common.apply_rope(q, positions, rope_theta)
        k = common.apply_rope(k, positions, rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    # the kernel reads each query head's K/V head by its group, where the
    # reference expands K/V to every head and annotates that expansion
    v = shard(v, "batch", "seq", "kv_heads", None)
    out = ops.flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal=causal, window=window,
                              softcap=softcap).transpose(1, 2)
    out = _project_out(p, out, x)
    if return_kv:
        return out, (k, v)
    return out


def _ring_valid(pos: int, S_max: int, window: int, device):
    """Which slots of a ring cache that holds token ``pos`` in slot
    ``pos % S_max`` fall inside the window, from each slot's absolute
    position."""
    idx = torch.arange(S_max, device=device)
    wrap = (pos // S_max) * S_max
    k_pos = torch.where(idx <= pos % S_max, wrap + idx, wrap - S_max + idx)
    return (k_pos >= 0) & (k_pos > pos - window) & (k_pos <= pos)


def decode_self_attention(p, x, cache: KVCache, pos: int, *, rope_theta,
                          window=0, softcap=0.0, qk_norm=False,
                          norm_eps=1e-6, use_rope=True):
    """Single-token decode.  x: [B, 1, D]; pos: the current position.

    With ``window`` > 0 the cache is a ring buffer.  The new K/V row is
    written into ``cache`` in place (the returned cache is the same
    storage).
    """
    q, k, v = _project_qkv(p, x, qk_norm, norm_eps)
    # 'dec_heads' (not 'heads'): decode-time q sharding is a separate
    # decision from weight TP
    q = shard(q, "batch", None, "dec_heads", None)
    if use_rope:
        positions = torch.full((1,), pos, dtype=torch.int64,
                               device=x.device)
        q = common.apply_rope(q, positions, rope_theta)
        k = common.apply_rope(k, positions, rope_theta)
    S_max = cache.k.shape[1]
    slot = pos % S_max if window > 0 else pos
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    if window > 0:
        k_valid = _ring_valid(pos, S_max, window, x.device)
    else:
        k_valid = torch.arange(S_max, device=x.device) <= pos
    out = _attend_one(q, cache.k, cache.v, k_valid, softcap)
    return _project_out(p, out, x), cache


def _attend_one(q, k, v, k_valid, softcap=0.0):
    """One query token over keys [B, S, Kh, D] (``k_valid`` [S] or None:
    all), in the grouped GQA form as one block: float32 scores and
    weights, as the reference's ``_attend_block``.  -> [B, 1, H, D]."""
    B, _, H, D = q.shape
    Kh = k.shape[2]
    qg = q.reshape(B, 1, Kh, H // Kh, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * (D ** -0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    if k_valid is not None:
        s = torch.where(k_valid, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = torch.sum(e, dim=-1)                                   # [B,Kh,G,1]
    o = torch.einsum("bkgqs,bskd->bqkgd", e.to(v.dtype).float(), v.float())
    o = o / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, 1, H, D).to(q.dtype)


def cross_attention(p, x, kv, *, qk_norm=False, norm_eps=1e-6):
    """Prefill cross-attention of x [B, Sq, D_model] over precomputed
    memory K/V (``cross_kv``: [B, Nv, Kh, D]): non-causal, no RoPE."""
    k, v = kv
    q = _project_q(p, x, qk_norm, norm_eps)
    out = ops.flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal=False).transpose(1, 2)
    return _project_out(p, out, x)


def decode_cross_attention(p, x, kv, *, qk_norm=False, norm_eps=1e-6):
    """Single-token cross-attention: x [B, 1, D_model] over the static
    memory K/V, which the decode never changes."""
    k, v = kv
    q = _project_q(p, x, qk_norm, norm_eps)
    return _project_out(p, _attend_one(q, k, v, None), x)
