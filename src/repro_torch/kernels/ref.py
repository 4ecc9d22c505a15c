"""Plain PyTorch versions of the port's forward kernels and of the two
backward kernels.

``decay_scan_ref`` and ``attention_ref`` transcribe ``repro.kernels.ref``'s
oracles of the same names (held to the JAX package's own tolerances on the
CPU); ``chunked_attention`` is the same attention in the order of the JAX
models' ``chunked_attention``, which ``ops.flash_attention`` runs on CPU
tensors so that autograd differentiates what ``jax.grad`` does; the CUDA
kernels ``csrc/decay_scan.cu`` (bitwise) and
``csrc/flash_attention.cu`` (to a tolerance) are held against them on the
card.  ``decay_scan_bwd_ref`` and ``attention_bwd_ref`` are their
gradients, written out as the backward kernels compute them (a reverse
loop; the FlashAttention-2 backward from the forward's log-sum-exp), and
hold ``csrc/decay_scan.cu``'s ``decay_scan_bwd`` (bitwise) and
``csrc/flash_attention_bwd.cu`` (to a tolerance) on the card.  The rest of
this module is the fused persistence-path RMW.

``thinning_rmw_ref`` transcribes ``repro.kernels.ref.thinning_rmw_ref`` and
is bitwise equal to it on the CPU: the same op sequence, each op rounded
once.  Three torch habits would break that and are designed out here:

* ``c / tensor`` is a reciprocal times ``c``, not an IEEE division, so a
  constant divided by a tensor is spelled ``torch.div(full_like(x, c), x)``;
* float32 ``torch.sqrt`` on the CPU is not correctly rounded, so square
  roots go through float64 (exact after rounding back to float32);
* XLA's CPU backend flushes denormals and torch does not: on the CPU the
  call runs with flush-to-zero on, on one thread — the flag is per thread
  and would not reach torch's intra-op worker threads.  Both settings are
  restored to what they were on entry.

The CUDA kernel (``csrc/thinning_rmw.cu``) computes the same function and
is held bitwise against this version on the CPU.  On a CUDA tensor this
version runs too (``chip_smoke.py`` times it), but without flush-to-zero.

``thinning_rmw_keyed_ref`` is the plain version of the keyed kernel: the
steps the JAX package leaves to XLA around its kernel — the counter-RNG
uniforms (``kernels/threefry.py``), the row gather (``gather_rows``) and, in
exact mode, the conflict-free scatter back into the state — composed around
``thinning_rmw_ref``.  ``gather_cuda_calls`` counts ``gather_rows`` calls on
CUDA tensors, so a run can show that its main path left the gather to the
kernel.

``segment_fold_ref`` is fast mode's fold as the engine ran it before
``csrc/segment_fold.cu``: whole tables, ``index_put_`` segment sums.  It
keeps the CPU's numerics (the engine's fast-mode tests against JAX run
through it) and holds the kernel to a relative tolerance on the card.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels.detmath import det_exp
from repro_torch.kernels.threefry import time_bits, uniform_for_events

POLICIES = ("pp", "pp_vr", "full", "fixed", "unfiltered")

# Sentinel for a never-persisted row (finite: -inf breaks 0*inf masking).
FRESH_SENTINEL = -1e38

gather_cuda_calls = 0   # gather_rows calls on CUDA tensors


def _cdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """IEEE ``c / x`` for a Python constant ``c`` (rounded once to f32)."""
    return torch.div(torch.full_like(x, c), x)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


# Held while the intra-op thread count is pinned to one: the count is
# process-wide, so two threads inside ``cpu_flush_denormals`` at once would
# hand each other back a multithreaded pool on exit.
_single_thread_lock = threading.RLock()


def _flushing_denormals() -> bool:
    """Whether the calling thread flushes denormals (one reads as zero)."""
    return bool((torch.tensor([1e-39]) * 1.0)[0] == 0)


@contextlib.contextmanager
def cpu_flush_denormals(device: torch.device):
    """Flush-to-zero on the calling thread and one intra-op thread (CPU).

    The flush flag is per thread; the thread count is process-wide, so the
    block holds a module lock (other callers of this helper wait).  Both
    are restored to their values on entry.
    """
    if device.type != "cpu":
        yield
        return
    with _single_thread_lock:
        threads = torch.get_num_threads()
        flushing = _flushing_denormals()
        torch.set_num_threads(1)
        torch.set_flush_denormal(True)
        try:
            yield
        finally:
            torch.set_flush_denormal(flushing)
            torch.set_num_threads(threads)


def thinning_rmw_ref(taus, last_t, v_f, agg_flat, q, t, u, valid,
                     v_full, last_t_full, *,
                     h: float, budget: float, alpha: float = 0.0,
                     policy: str = "pp", fixed_rate: float = 0.1,
                     mu_tau_index: int = 2, min_p: float = 1e-6):
    """Plain fused decision + update over gathered rows.

    Shapes: taus [T]; last_t, v_f, q, t, u, valid, v_full, last_t_full: [B]
    float32 (``valid`` as 0/1); agg_flat: [B, 3T] (tau-major).  Fresh rows
    carry ``last_t = -1e38`` (and ``last_t_full = -1e38``).  Returns
    (new_last_t, new_v_f, new_agg_flat, z, p, features[B, 4T], lam,
    new_v_full, new_last_t_full).
    """
    with cpu_flush_denormals(last_t.device):
        return _thinning_rmw(taus, last_t, v_f, agg_flat, q, t, u, valid,
                             v_full, last_t_full, h=h, budget=budget,
                             alpha=alpha, policy=policy,
                             fixed_rate=fixed_rate,
                             mu_tau_index=mu_tau_index, min_p=min_p)


def _thinning_rmw(taus, last_t, v_f, agg_flat, q, t, u, valid, v_full,
                  last_t_full, *, h, budget, alpha, policy, fixed_rate,
                  mu_tau_index, min_p):
    B = last_t.shape[0]
    T = taus.shape[0]
    agg = agg_flat.reshape(B, T, 3)
    fresh = last_t < -1e30
    dt = torch.where(fresh, 0.0, torch.clamp_min(t - last_t, 0.0))
    fresh_full = last_t_full < -1e30
    dt_full = torch.where(fresh_full, 0.0,
                          torch.clamp_min(t - last_t_full, 0.0))
    # dt * (-1/tau), never -(dt/tau): the reference's spelling.
    neg_inv_taus = _cdiv(-1.0, taus)
    neg_inv_h = -1.0 / h          # Python double, rounded once to f32 below
    inv_h = 1.0 / h
    packed = det_exp(torch.cat(
        [dt[:, None] * neg_inv_taus[None, :],
         (dt * neg_inv_h)[:, None], (dt_full * neg_inv_h)[:, None]], dim=1))
    beta_tau = torch.where(fresh[:, None], 0.0, packed[:, :T])
    beta_h = torch.where(fresh, 0.0, packed[:, T])
    beta_hf = torch.where(fresh_full, 0.0, packed[:, T + 1])
    agg_now = agg * beta_tau[..., None]

    cnt, sm, sq = agg_now[..., 0], agg_now[..., 1], agg_now[..., 2]
    cnt_floor = torch.clamp_min(cnt, 1e-12)
    mean = sm / cnt_floor
    var = torch.clamp_min(sq / cnt_floor - mean * mean, 0.0)
    feats = torch.cat([cnt, sm, mean, _sqrt(var)], dim=1)

    if policy == "full":
        lam = (1.0 + beta_hf * v_full) * inv_h
    else:
        lam = (1.0 + beta_h * v_f) * inv_h
    base = torch.clamp_max(_cdiv(budget, torch.clamp_min(lam, 1e-30)), 1.0)
    if policy == "unfiltered":
        p = torch.ones_like(lam)
    elif policy == "fixed":
        p = torch.full_like(lam, fixed_rate)
    elif policy == "pp_vr":
        cold = cnt[:, mu_tau_index] < 1.0
        mu_w = torch.where(cold, 0.0, mean[:, mu_tau_index])
        sg = torch.where(cold, 1e8, _sqrt(var[:, mu_tau_index]) + 1e-8)
        zs = torch.clamp((q - mu_w) / torch.clamp_min(sg, 1e-8), -8.0, 8.0)
        b = torch.clamp(base, 1e-6, 1.0 - 1e-6)
        # log-free sigmoid(logit(b) + alpha*zs), as in the reference
        odds = (1.0 - b) / b
        e_tilt = det_exp(zs * (-alpha))
        p = torch.where(base >= 1.0 - 1e-6, 1.0,
                        _cdiv(1.0, 1.0 + odds * e_tilt))
    else:  # 'pp' and the decision half of 'full'
        p = base
    p = torch.clamp(p, min_p, 1.0)

    valid_b = valid > 0.5
    z = (u < p) & valid_b
    inv_p = torch.where(z, _cdiv(1.0, p), 0.0)
    w = torch.stack([torch.ones_like(q), q, q * q], dim=-1)       # [B, 3]
    agg_new = agg_now + inv_p[:, None, None] * w[:, None, :]
    new_agg = torch.where(z[:, None, None], agg_new, agg)
    new_v_f = torch.where(z, inv_p + beta_h * v_f, v_f)
    new_last_t = torch.where(z, t, last_t)
    new_v_full = torch.where(valid_b, 1.0 + beta_hf * v_full, v_full)
    new_last_t_full = torch.where(valid_b, t, last_t_full)
    return (new_last_t, new_v_f, new_agg.reshape(B, 3 * T), z, p, feats,
            lam, new_v_full, new_last_t_full)


def gather_rows(state, key: torch.Tensor):
    """One profile row per event, sentinel-mapped for the fused pass.

    ``state``: the five columns ``(last_t [N], v_f [N], agg [N, T, 3],
    v_full [N], last_t_full [N])`` (a ``ProfileState``); ``key``: int64
    [B].  A non-finite ``last_t``/``last_t_full`` (a never-persisted row)
    becomes ``FRESH_SENTINEL``.  Returns (last_t, v_f, agg_flat[B, 3T],
    v_full, last_t_full).
    """
    global gather_cuda_calls
    if key.is_cuda:
        gather_cuda_calls += 1
    last_t, v_f, agg, v_full, last_t_full = state
    fin = lambda x: torch.where(torch.isfinite(x), x, FRESH_SENTINEL)
    take = lambda x: torch.index_select(x, 0, key)
    return (fin(take(last_t)), take(v_f), take(agg).reshape(key.shape[0], -1),
            take(v_full), fin(take(last_t_full)))


def thinning_rmw_keyed_ref(taus, state, key, q, t, valid, rng, ent=None, *,
                           write_back: bool = False, lanes=None, out=None,
                           **kw):
    """Plain keyed fused pass: uniforms, gather, ``thinning_rmw_ref``.

    ``state``: the five state columns (a ``ProfileState``); ``key``/``ent``
    int64 [L] (``ent``, the counter-RNG entity, defaults to ``key``);
    ``q``/``t`` float32 [L]; ``valid`` bool [L]; ``rng`` a key.  Row ``i``
    of the pass is event ``lanes[i]`` (event ``i`` when ``lanes`` is None);
    ``lanes[i] >= L`` marks an empty row.  An event is active when it is
    valid and its row is not empty; an inactive one reads table row 0 and
    draws its uniform for entity 0 (``core/engine.py`` of the JAX package
    masks its keys the same way).  ``kw``: the ``thinning_rmw`` parameters.

    Decision only (``write_back=False``, no ``lanes``): returns
    ``(z, p, features, lam)`` per event and leaves the state alone.

    ``write_back=True``: active keys must be distinct.  Where ``z`` the
    persisted columns (``agg``, ``v_f``, ``last_t = t``), where active the
    control column (``v_full``, ``last_t_full = t``) are written into the
    state in place, and each active event's ``(z, p, features, lam)`` into
    slot ``lanes[i]`` of ``out`` (four tensors of L rows, updated in place
    and returned).  Inactive rows write nothing.
    """
    L = key.shape[0]
    if lanes is None:
        lane = torch.arange(L, device=key.device)
        active = valid
    else:
        inside = lanes < L
        lane = torch.where(inside, lanes, 0)
        active = inside & valid[lane]
    ent = key if ent is None else ent
    row = torch.where(active, key[lane], 0)
    t_l = t[lane]
    u = uniform_for_events(rng, torch.where(active, ent[lane], 0),
                           time_bits(t_l))
    last_t, v_f, agg_flat, v_full, last_t_full = gather_rows(state, row)
    (_, new_v_f, new_agg, z, p, feats, lam, new_v_full, _) = thinning_rmw_ref(
        taus, last_t, v_f, agg_flat, q[lane], t_l, u,
        active.to(torch.float32), v_full, last_t_full, **kw)
    if not write_back:
        return z, p, feats, lam
    s_last_t, s_v_f, s_agg, s_v_full, s_last_t_full = state
    wrote = row[z]
    s_agg[wrote] = new_agg[z].reshape(-1, *s_agg.shape[1:])
    s_v_f[wrote] = new_v_f[z]
    s_last_t[wrote] = t_l[z]
    seen = row[active]
    s_v_full[seen] = new_v_full[active]
    s_last_t_full[seen] = t_l[active]
    slot = lane[active]
    for dst, val in zip(out, (z, p, feats, lam)):
        dst[slot] = val[active]
    return out


def _decay(dt: torch.Tensor, h) -> torch.Tensor:
    """exp(-dt/h) with dt=inf (a fresh row) mapping to 0
    (``core.intensity.decay``)."""
    dt = torch.clamp_min(dt, 0.0)
    return torch.where(torch.isfinite(dt), torch.exp(-dt / h), 0.0)


def segment_fold_ref(taus, state, key, q, t, valid, z, p, *, h: float):
    """Plain closed-form segment fold of a fast block, in place.

    ``state``: the five state columns (a ``ProfileState``, N rows);
    ``key`` int64 [B]; ``q``/``t``/``p`` float32 [B]; ``valid``/``z`` bool
    [B] (the decision stage's ``z`` and ``p``).  Per key with persisted
    lanes, at their latest time t*: ``v_f <- sum (1/p) e^{-(t*-t_i)/h} +
    e^{-(t*-last_t)/h} v_f``, the [T, 3] aggregates the same per tau with
    weights (1, q, q^2), ``last_t <- t*``; per key with valid lanes the
    control column ``v_full``/``last_t_full`` by the same rule over every
    valid lane, weight 1.  Other rows keep their bits.

    The fold works on whole tables: scratch tables have a spare row N for
    the lanes that do not contribute, and the segment sums are
    ``index_put_(accumulate=True)``, which on the CPU adds with atomics
    across threads, so it runs on one thread here.
    """
    last_t, v_f, agg, v_full, last_t_full = state
    dev = last_t.device
    num_e = last_t.shape[0]
    safe_key = torch.where(valid, key, 0)

    def seg_max(idx, val):
        out = torch.full((num_e + 1,), -torch.inf, dtype=torch.float32,
                         device=dev)
        return out.scatter_reduce_(0, idx, val, "amax")[:num_e]

    def seg_sum(idx, val):
        out = torch.zeros((num_e + 1,) + val.shape[1:], dtype=torch.float32,
                          device=dev)
        with cpu_flush_denormals(dev):      # one thread on the CPU
            out.index_put_((idx,), val, accumulate=True)
        return out[:num_e]

    data_idx = torch.where(z, key, num_e)
    t_star = seg_max(data_idx, t)           # last persisted time per key
    wrote = torch.isfinite(t_star)
    t_ref = torch.where(wrote, t_star, 0.0)

    inv_p = torch.where(z, torch.reciprocal(p), 0.0)
    dt_ev = t_ref[safe_key] - t
    # v_f: sum_i (1/p_i) exp(-(t* - t_i)/h) + decay(t* - last_t) * v_f
    v_add = seg_sum(data_idx, inv_p * _decay(dt_ev, h))
    v_f_new = torch.where(
        wrote, v_add + _decay(t_star - last_t, h) * v_f, v_f)

    # aggregates: same fold per tau/column
    beta_ev = _decay(dt_ev[:, None], taus)                   # [B, T]
    w = torch.stack([torch.ones_like(q), q, q * q], -1)
    contrib = inv_p[:, None, None] * beta_ev[:, :, None] * w[:, None, :]
    agg_decayed = agg * _decay((t_star - last_t)[:, None], taus)[..., None]
    agg_new = torch.where(wrote[:, None, None],
                          seg_sum(data_idx, contrib) + agg_decayed, agg)
    last_t_new = torch.where(wrote, t_star, last_t)

    # full-stream control column (every valid event)
    ctrl_idx = torch.where(valid, key, num_e)
    tf_star = seg_max(ctrl_idx, t)
    saw = torch.isfinite(tf_star)
    tf_ref = torch.where(saw, tf_star, 0.0)
    w_full = torch.where(valid, 1.0, 0.0) * _decay(tf_ref[safe_key] - t, h)
    v_full_new = torch.where(
        saw, seg_sum(ctrl_idx, w_full)
        + _decay(tf_star - last_t_full, h) * v_full, v_full)
    last_t_full_new = torch.where(saw, tf_star, last_t_full)

    for dst, new in ((last_t, last_t_new), (v_f, v_f_new), (agg, agg_new),
                     (v_full, v_full_new), (last_t_full, last_t_full_new)):
        dst.copy_(new)


def decay_scan_ref(a: torch.Tensor, u: torch.Tensor,
                   h0: torch.Tensor | None = None) -> torch.Tensor:
    """h[t] = a[t]*h[t-1] + u[t], a loop over T.  a, u: [T, C]; h0: [C].

    The product and the sum are two torch ops, each rounded once, so the
    CUDA kernel (``__fmul_rn`` then ``__fadd_rn``) is bitwise equal to it.
    """
    h = torch.zeros_like(a[0]) if h0 is None else h0
    out = torch.empty_like(a)
    for t in range(a.shape[0]):
        h = a[t] * h
        h = h + u[t]
        out[t] = h
    return out


def decay_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor,
                       h0: torch.Tensor | None = None):
    """The gradient of ``decay_scan_ref``: a reverse loop over T.

    a, h (the forward's states), g (the gradient of h): [T, C] float32;
    h0: [C] or None.  ``dh[t] = g[t] + a[t+1] * dh[t+1]`` (the sum of the
    cotangents reaching h[t]), ``du = dh``, ``da[t] = dh[t] * h[t-1]``
    (``h[-1]`` = h0, or 0) and ``dh0 = a[0] * dh[0]`` (None without h0).
    Returns ``(da, du, dh0)``.  Each product and each sum is one torch op,
    rounded once, so the CUDA kernel is bitwise equal to it.
    """
    T = a.shape[0]
    dh = torch.empty_like(g)
    da = torch.empty_like(a)
    carry = torch.zeros_like(g[0])
    a_next = torch.zeros_like(a[0])
    for t in range(T - 1, -1, -1):
        carry = a_next * carry
        carry = g[t] + carry
        dh[t] = carry
        if t > 0:
            da[t] = carry * h[t - 1]
        elif h0 is not None:
            da[t] = carry * h0
        else:
            da[t] = carry * torch.zeros_like(carry)
        a_next = a[t]
    dh0 = None
    if h0 is not None:
        dh0 = a[0] * dh[0] if T else torch.zeros_like(h0)
    return da, dh, dh0


def _attention_scores(q, k, causal, window, softcap):
    """Float32 scores [B, H, Sq, Skv] (scaled, softcapped, unmasked), the
    tanh of the softcap (or None) and the mask [Sq, Skv]."""
    B, H, Sq, D = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    kk = k.repeat_interleave(H // Kh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * (D ** -0.5)
    th = None
    if softcap > 0:
        th = torch.tanh(s / softcap)
        s = th * softcap
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return s, th, mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, return_lse: bool = False):
    """Dense attention.  q: [B,H,Sq,D]; k, v: [B,Kh,Skv,D] -> [B,H,Sq,D].

    K/V are repeated over the group; scores are float32 (products of the
    inputs, exact for bfloat16), masked to -1e30; the softmax weights are
    rounded to ``v.dtype`` before the float32 PV product.  With
    ``return_lse`` also the rows' log-sum-exp of the masked scores,
    float32 [B, H, Sq] (what the backward reads).
    """
    H, Kh = q.shape[1], k.shape[1]
    s, _, mask = _attention_scores(q, k, causal, window, softcap)
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    vv = v.repeat_interleave(H // Kh, dim=1)
    out = torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype).float(), vv.float())
    out = out.to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _attend_block(qg, k, v, q_pos, k_pos, scale, causal, window, softcap):
    """One (query block, key block) of ``chunked_attention``: (o, m, l),
    the unnormalised float32 output [B, Sq, Kh, G, D] and the rows' max
    and sum [B, Sq, Kh, G], as the reference's ``_attend_block``."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=qg.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(mask, s, -1e30)
    m = torch.amax(s, dim=-1)                                  # [B,Kh,G,Sq]
    e = torch.exp(s - m[..., None])
    l = torch.sum(e, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", e.to(v.dtype).float(), v.float())
    return o, m.permute(0, 3, 1, 2), l.permute(0, 3, 1, 2)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_chunk: int = 1024,
                      kv_chunk: int = 1024, expand_kv: bool = True):
    """Attention in the JAX package's order (``repro.models.attention.
    chunked_attention``), so that autograd differentiates the operations
    ``jax.grad`` does.  q: [B,H,Sq,D]; k, v: [B,Kh,Skv,D] (the kernel's
    layout) -> [B,H,Sq,D].

    K/V are expanded over the group first (``expand_kv``); each block
    takes ``e = exp(s - m)``, ``o = e v`` in float32 (the weights rounded
    to ``v.dtype``) and divides by ``max(l, 1e-30)`` after the product:
    in one block when ``Sq % q_chunk`` or ``Skv % kv_chunk`` is nonzero,
    else over key blocks merged by the online softmax.  The same function
    as ``attention_ref`` (to float32 rounding)."""
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))       # [B,S,H,D]
    B, Sq, H, D = qs.shape
    Kh = ks.shape[2]
    G = H // Kh
    scale = D ** -0.5
    if G > 1 and expand_kv:
        ks = ks.repeat_interleave(G, dim=2)
        vs = vs.repeat_interleave(G, dim=2)
        Kh, G = H, 1
    qg = qs.reshape(B, Sq, Kh, G, D)
    Skv = ks.shape[1]
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        o, m, l = _attend_block(qg, ks, vs, q_pos, k_pos, scale, causal,
                                window, softcap)
        out = o / torch.clamp_min(l, 1e-30)[..., None]
        return out.reshape(B, Sq, H, D).to(q.dtype).transpose(1, 2)
    outs = []
    for i in range(0, Sq, q_chunk):
        qi, qpi = qg[:, i:i + q_chunk], q_pos[i:i + q_chunk]
        acc = qg.new_zeros((B, q_chunk, Kh, G, D), dtype=torch.float32)
        m_run = torch.full((B, q_chunk, Kh, G), -1e30, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros_like(m_run)
        for j in range(0, Skv, kv_chunk):
            o, m_new, l_new = _attend_block(
                qi, ks[:, j:j + kv_chunk], vs[:, j:j + kv_chunk], qpi,
                k_pos[j:j + kv_chunk], scale, causal, window, softcap)
            m_next = torch.maximum(m_run, m_new)
            c_old = torch.exp(m_run - m_next)
            c_new = torch.exp(m_new - m_next)
            acc = acc * c_old[..., None] + o * c_new[..., None]
            l_run = l_run * c_old + l_new * c_new
            m_run = m_next
        outs.append(acc / torch.clamp_min(l_run, 1e-30)[..., None])
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, D)
    return out.to(q.dtype).transpose(1, 2)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0, softcap: float = 0.0):
    """The explicit FlashAttention-2 backward of ``attention_ref``, in
    float32 whatever the inputs' dtype.

    o: the forward's output; lse: its rows' log-sum-exp [B, H, Sq]; do: the
    gradient of o.  P = exp(s - lse) on the kept pairs (0 elsewhere),
    dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dO o)), times the
    softcap's derivative 1 - tanh^2(s / c) where there is one; dQ =
    D^-0.5 dS K, dK = D^-0.5 dS^T Q.  dK and dV are summed over the G query
    heads of each KV head.  Returns (dq, dk, dv) in the inputs' dtypes.
    """
    B, H, Sq, D = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    G = H // Kh
    s, th, mask = _attention_scores(q, k, causal, window, softcap)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    dof = do.float()
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if th is not None:
        ds = ds * (1.0 - th * th)
    scale = D ** -0.5
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dk = dk.view(B, Kh, G, Skv, D).sum(2)
    dv = dv.view(B, Kh, G, Skv, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
