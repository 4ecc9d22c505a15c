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

Under a tensor-parallel context (``distributed.context.tp_context``) the
rank computes its query heads where the rules split ``heads`` over
``"model"`` (``num_heads`` / ``num_kv_heads`` name the whole counts): its
shard of ``wq``, its KV heads (its shard of ``wk`` / ``wv`` where
``kv_heads`` splits too, else the KV heads its query heads read, taken
from the whole projection) and its rows of ``wo``, whose partial output
is summed over the ranks (``common.region_out``).  The flash kernel runs
on the local heads.  A decode step over a cache split by ``kv_seq``
attends this rank's slots only and merges the ranks' outputs by their
log-sum-exp (``collectives.combine_softmax``): no rank ever holds another
rank's slots.  The new token's K/V are written by the slot's owner.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import context as dctx
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


class HeadPlan(NamedTuple):
    """How a rank splits attention: ``local`` (its query heads ``q`` of
    ``num_heads``), ``kv_local`` (``wk`` / ``wv`` split too) and ``kv``,
    which KV heads of the whole projection its query heads read (a slice,
    or an index with one KV head a query head)."""
    local: bool
    q: slice
    kv_local: bool
    kv: object


def head_plan(num_heads, num_kv_heads) -> HeadPlan:
    """This rank's split of the heads under the installed tensor-parallel
    context (whole without one, or where ``heads`` does not divide)."""
    H, Kh = num_heads, num_kv_heads
    if H is None or Kh is None or not dctx.is_local("heads", H):
        return HeadPlan(False, slice(0, H or 0), False, None)
    q = dctx.local_slice("heads", H)
    G = H // Kh
    kv_local = dctx.is_local("kv_heads", Kh)
    h0, h1 = q.start, q.stop
    if kv_local or (h0 % G == 0 and (h1 - h0) % G == 0):
        kv = slice(h0 // G, h1 // G)
    elif h0 // G == (h1 - 1) // G:
        kv = slice(h0 // G, h0 // G + 1)
    else:
        kv = torch.arange(h0, h1) // G
    return HeadPlan(True, q, kv_local, kv)


def _tp_params(p, hp: HeadPlan):
    """The layer's parameters as the rank's compute uses them: replicated
    ones that local heads read get their gradient summed, a split
    ``head_dim`` norm is gathered, the output bias sees the rows."""
    if dctx.tp_state() is None:
        return p
    p = dict(p)
    if "bo" in p:
        p["bo"] = common.row_param(p["bo"])
    if not hp.local:
        return p
    if not hp.kv_local:
        for k in ("wk", "wv", "bk", "bv"):
            if k in p:
                p[k] = common.region_param(p[k])
    Dh = p["wq"].shape[-1]
    for k in ("q_norm", "k_norm"):
        if k in p:
            p[k] = common.whole_param(p[k], "head_dim", 0, Dh)
    return p


def _local_kv(x, hp: HeadPlan, Kh):
    """K or V [B, S, Kh?, D] -> the KV heads the rank's query heads read
    (as they are for whole compute, or where they are the rank's
    projection already)."""
    if not hp.local or x.shape[2] != Kh:
        return x
    if isinstance(hp.kv, slice):
        return x[:, :, hp.kv]
    return x[:, :, hp.kv.to(x.device)]


def _whole_kv(x, hp: HeadPlan, Kh):
    """K or V with every KV head (gathered where the rank holds its
    shard): what a cache keeps."""
    if hp.local and x.shape[2] != Kh:
        return collectives.gather_model(x, dctx.model_group(), 2)
    return x


def _in_proj(x, w, local=False, sp=None):
    """x [B, S, D] by w [D, H, K] -> [B, S, H, K] (one matrix product, as
    the einsum "bsd,dhk->bshk"; column-parallel where ``local``)."""
    return common.col_matmul(x, w.to(x.dtype).flatten(1), local,
                             sp).unflatten(-1, w.shape[1:])


def _project_q(p, x, qk_norm, norm_eps, local=False):
    q = _in_proj(x, p["wq"], local)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    if qk_norm:
        q = common.rms_norm(q, p["q_norm"], norm_eps)
    return q


def cross_kv(p, kv_src, *, qk_norm=False, norm_eps=1e-6, local=False,
             sp=None):
    """Project the memory (the vision tokens) [B, Nv, D_model] to K/V
    [B, Nv, Kh, D] once; the decode reuses them.  Also the K/V of
    self-attention, where the memory is the input itself."""
    k = _in_proj(kv_src, p["wk"], local, sp)
    v = _in_proj(kv_src, p["wv"], local, sp)
    if "bk" in p:
        k = k + p["bk"].to(kv_src.dtype)
        v = v + p["bv"].to(kv_src.dtype)
    if qk_norm:
        k = common.rms_norm(k, p["k_norm"], norm_eps)
    return k, v


def memory_kv(p, kv_src, *, qk_norm=False, norm_eps=1e-6, num_heads=None,
              num_kv_heads=None):
    """``cross_kv`` of the vision memory under the installed split: the
    rank's KV heads (or all of them), from the memory, which every rank
    holds whole."""
    hp = head_plan(num_heads, num_kv_heads)
    p = _tp_params(p, hp)
    return cross_kv(p, kv_src, qk_norm=qk_norm, norm_eps=norm_eps,
                    local=hp.local, sp=False)


def whole_memory(kv, num_heads=None, num_kv_heads=None):
    """The memory K/V of ``memory_kv`` with every KV head (what a cross
    layer's cache keeps)."""
    hp = head_plan(num_heads, num_kv_heads)
    return tuple(_whole_kv(t, hp, num_kv_heads) for t in kv)


def _project_qkv(p, x, qk_norm, norm_eps, local):
    k, v = cross_kv(p, x, qk_norm=qk_norm, norm_eps=norm_eps, local=local)
    return _project_q(p, x, qk_norm, norm_eps, local), k, v


def _project_out(p, out, x, local=False):
    dt = out.dtype
    out = common.row_matmul(out.flatten(2), p["wo"].to(dt).flatten(0, 1),
                            local)
    out = common.region_out(out, local, dt)
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return shard(out, "batch", "seq", None)


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> contiguous [B, H, S, D] (the kernel's layout)."""
    return x.transpose(1, 2).contiguous()


def self_attention(p, x, positions, *, rope_theta, causal=True, window=0,
                   softcap=0.0, qk_norm=False, norm_eps=1e-6, use_rope=True,
                   return_kv=False, num_heads=None, num_kv_heads=None):
    """Prefill self-attention.  x: [B, S, D_model], positions: [S].  With
    ``return_kv`` also K/V [B, S, Kh, D] with every KV head."""
    hp = head_plan(num_heads, num_kv_heads)
    xin = common.region_in(x, hp.local)
    p = _tp_params(p, hp)
    q, k, v = _project_qkv(p, xin, qk_norm, norm_eps, hp.local)
    if use_rope:
        q = common.apply_rope(q, positions, rope_theta)
        k = common.apply_rope(k, positions, rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    # the kernel reads each query head's K/V head by its group, where the
    # reference expands K/V to every head and annotates that expansion
    v = shard(v, "batch", "seq", "kv_heads", None)
    kl, vl = _local_kv(k, hp, num_kv_heads), _local_kv(v, hp, num_kv_heads)
    out = ops.flash_attention(_heads_first(q), _heads_first(kl),
                              _heads_first(vl), causal=causal, window=window,
                              softcap=softcap).transpose(1, 2)
    out = _project_out(p, out.to(xin.dtype), x, hp.local)
    if return_kv:
        return out, (_whole_kv(k, hp, num_kv_heads),
                     _whole_kv(v, hp, num_kv_heads))
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
                          norm_eps=1e-6, use_rope=True, num_heads=None,
                          num_kv_heads=None, cache_len=None):
    """Single-token decode.  x: [B, 1, D]; pos: the current position.

    With ``window`` > 0 the cache is a ring buffer.  The new K/V row is
    written into ``cache`` in place (the returned cache is the same
    storage).  ``cache_len`` is the whole cache's length: where the rules
    split ``kv_seq`` over ``"model"``, ``cache`` holds this rank's slots
    of it, which the step attends alone, and the ranks' outputs are
    merged by log-sum-exp.
    """
    hp = head_plan(num_heads, num_kv_heads)
    xin = common.region_in(x, hp.local)
    p = _tp_params(p, hp)
    q, k, v = _project_qkv(p, xin, qk_norm, norm_eps, hp.local)
    # 'dec_heads' (not 'heads'): decode-time q sharding is a separate
    # decision from weight TP
    q = shard(q, "batch", None, "dec_heads", None)
    if use_rope:
        positions = torch.full((1,), pos, dtype=torch.int64,
                               device=x.device)
        q = common.apply_rope(q, positions, rope_theta)
        k = common.apply_rope(k, positions, rope_theta)
    S_max = cache.k.shape[1] if cache_len is None else cache_len
    seq = dctx.local_slice("kv_seq", S_max)
    split = seq.stop - seq.start < S_max
    if hp.local and split:
        # every head attends this rank's slots: the heads' queries and the
        # new token's K/V come whole ([B, 1, H, D]: no cache moves)
        q = collectives.gather_model(q, dctx.model_group(), 2)
    k = _whole_kv(k, hp, num_kv_heads)
    v = _whole_kv(v, hp, num_kv_heads)
    slot = pos % S_max if window > 0 else pos
    if seq.start <= slot < seq.stop:
        cache.k[:, slot - seq.start] = k[:, 0].to(cache.k.dtype)
        cache.v[:, slot - seq.start] = v[:, 0].to(cache.v.dtype)
    if window > 0:
        k_valid = _ring_valid(pos, S_max, window, x.device)
    else:
        k_valid = torch.arange(S_max, device=x.device) <= pos
    k_valid = k_valid[seq]
    if split:
        o, lse = _attend_one(q, cache.k, cache.v, k_valid, softcap,
                             return_lse=True)
        out = collectives.combine_softmax(o, lse, dctx.model_group()).to(
            q.dtype)
        if hp.local:
            out = out[:, :, hp.q]
    else:
        out = _attend_one(q, _local_kv(cache.k, hp, num_kv_heads),
                          _local_kv(cache.v, hp, num_kv_heads), k_valid,
                          softcap)
    return _project_out(p, out, x, hp.local), cache


def _attend_one(q, k, v, k_valid, softcap=0.0, return_lse=False):
    """One query token over keys [B, S, Kh, D] (``k_valid`` [S] or None:
    all), in the grouped GQA form as one block: float32 scores and
    weights, as the reference's ``_attend_block``.  -> [B, 1, H, D]; with
    ``return_lse`` the float32 output and the rows' log-sum-exp [B, 1,
    H]."""
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
    if return_lse:
        lse = (m[..., 0] + torch.log(l)).permute(0, 3, 1, 2)  # [B,1,Kh,G]
        return o.reshape(B, 1, H, D), lse.reshape(B, 1, H)
    return o.reshape(B, 1, H, D).to(q.dtype)


def cross_attention(p, x, kv, *, qk_norm=False, norm_eps=1e-6,
                    num_heads=None, num_kv_heads=None):
    """Prefill cross-attention of x [B, Sq, D_model] over precomputed
    memory K/V (``cross_kv``: [B, Nv, Kh, D], every KV head or the rank's
    as ``memory_kv`` gives them): non-causal, no RoPE."""
    hp = head_plan(num_heads, num_kv_heads)
    xin = common.region_in(x, hp.local)
    p = _tp_params(p, hp)
    k, v = (_local_kv(t, hp, num_kv_heads) for t in kv)
    q = _project_q(p, xin, qk_norm, norm_eps, hp.local)
    out = ops.flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal=False,
                              kv_chunk=min(k.shape[1], 2048)).transpose(1, 2)
    return _project_out(p, out.to(xin.dtype), x, hp.local)


def decode_cross_attention(p, x, kv, *, qk_norm=False, norm_eps=1e-6,
                           num_heads=None, num_kv_heads=None):
    """Single-token cross-attention: x [B, 1, D_model] over the static
    memory K/V (every KV head), which the decode never changes."""
    hp = head_plan(num_heads, num_kv_heads)
    xin = common.region_in(x, hp.local)
    p = _tp_params(p, hp)
    k, v = (_local_kv(t, hp, num_kv_heads) for t in kv)
    q = _project_q(p, xin, qk_norm, norm_eps, hp.local)
    return _project_out(p, _attend_one(q, k, v, None), x, hp.local)
