"""Plain PyTorch versions of the port's three kernels.

``decay_scan_ref`` and ``attention_ref`` transcribe ``repro.kernels.ref``'s
oracles of the same names (held to the JAX package's own tolerances on the
CPU); the CUDA kernels ``csrc/decay_scan.cu`` (bitwise) and
``csrc/flash_attention.cu`` (to a tolerance) are held against them on the
card.  The rest of this module is the fused persistence-path RMW.

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
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels.detmath import det_exp

POLICIES = ("pp", "pp_vr", "full", "fixed", "unfiltered")

# Sentinel for a never-persisted row (finite: -inf breaks 0*inf masking).
FRESH_SENTINEL = -1e38


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


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """Dense attention.  q: [B,H,Sq,D]; k, v: [B,Kh,Skv,D] -> [B,H,Sq,D].

    K/V are repeated over the group; scores are float32 (products of the
    inputs, exact for bfloat16), masked to -1e30; the softmax weights are
    rounded to ``v.dtype`` before the float32 PV product.
    """
    B, H, Sq, D = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    G = H // Kh
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * (D ** -0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype).float(), vv.float())
    return out.to(q.dtype)
