"""Plain reference of the persistence path in fast mode, and of the scorer.

Written from the paper's equations and the engine's documented fast-mode
semantics, in plain PyTorch and NumPy on the CPU; it imports nothing of the
program under test.  The semantics, per key:

* every event of a block decides against its key's row as the block began:
  the row decays lazily to the event's time (``exp(-dt/tau)`` per window,
  ``exp(-dt/h)`` for the filtered KDE numerator), the features are the
  decayed count, sum, mean and standard deviation per window, the
  intensity is ``(1 + decay * v_f) / h``, the inclusion probability is
  Eq. 2 (``pp``) or Eq. 4 (``pp_vr``), and the event persists when its
  counter-RNG uniform lies below it;
* after the block, each key's persisted events fold into its row at the
  key's last persisted time ``t*``: ``v_f = sum(1/p_i exp(-(t*-t_i)/h)) +
  exp(-(t*-last_t)/h) v_f`` and the same for the aggregates per window
  with weights ``(1, q, q^2)``; ``last_t = t*``.

Keys are independent in this mode, so a sample of keys is followed
exactly.  Two ways, for two uses:

* ``replay`` runs the semantics from empty rows on its own decisions, in
  float32 or one precision below (bfloat16: the control in the program's
  place; timestamps stay float32: they are inputs, not arithmetic);
* ``expect`` judges a program step by step, in float64: each decision
  from the row the program reports it saw (its features and lambda-hat),
  and each row the program reports from the one it reported a block
  before with the events it persisted folded in; the first from empty
  rows.  Under Eq. 4 a free-running float32 replay cannot follow a key
  for long: the variance is a difference, E[q^2] - mean^2, that amplifies
  the rows' rounding by mean^2 / var, and each persisted event's weight
  1/p feeds that back into the row, so two sound float32 programs that sum
  in different orders part for good.

The uniforms are threefry-2x32 as ``jax.random`` draws them
(``fold_in(fold_in(key, entity), bits(t))``), copied here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on int64 numpy arrays of uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def uniforms(rng_words, entity: np.ndarray, t: np.ndarray) -> np.ndarray:
    """U[0, 1) of each event: the entity and the float32 bits of its time
    folded into the key, then one block; top 23 bits as the mantissa."""
    k0, k1 = (int(w) & _M32 for w in rng_words)
    ent = np.asarray(entity, np.int64) & _M32
    bits_t = np.asarray(t, np.float32).view(np.uint32).astype(np.int64)
    zero = np.zeros_like(ent)
    a0, a1 = threefry2x32(np.full_like(ent, k0), np.full_like(ent, k1),
                          zero, ent)
    b0, b1 = threefry2x32(a0, a1, zero, bits_t)
    c0, c1 = threefry2x32(b0, b1, zero, zero)
    bits = (((c0 ^ c1) >> 9) | 0x3F800000).astype(np.uint32)
    return bits.view(np.float32) - np.float32(1.0)


class Engine(NamedTuple):
    """The engine settings a configuration file states."""
    taus: tuple
    h: float
    budget: float            # Lambda, writes per second per key
    policy: str              # pp | pp_vr
    alpha: float
    mu_tau_index: int
    min_p: float


def engine_from_config(config: dict) -> Engine:
    e = config["engine"]
    h = float(e["kde_bandwidth_s"])
    return Engine(taus=tuple(float(x) for x in e["windows_s"]), h=h,
                  budget=float(e["lambda_h"]) / h, policy=e["policy"],
                  alpha=float(e["variance_alpha"]),
                  mu_tau_index=int(e["mu_tau_index"]),
                  min_p=float(e["min_p"]))


class Replay(NamedTuple):
    u: np.ndarray          # [n] float32 uniforms
    z: np.ndarray          # [n] bool
    p: np.ndarray          # [n] float32
    lam: np.ndarray        # [n] float32
    features: np.ndarray   # [n, 4T] float32
    last_t: np.ndarray     # [K] float32 final rows (-inf: never persisted)
    v_f: np.ndarray        # [K]
    agg: np.ndarray        # [K, T, 3]
    persisted: np.ndarray  # [K] bool: some event of the key persisted


def replay(eng: Engine, slot, entity, q, t, block, rng_words, n_slots: int,
           dtype=torch.float32) -> Replay:
    """Follow ``n_slots`` keys through their events.

    ``slot``: each event's key as an index in [0, n_slots); ``entity``: its
    global id (the RNG's entity); ``block``: the engine block it ran in
    (non-decreasing: events are given in stream order).  Events of one
    block decide together, against the rows as the block began.
    """
    if eng.policy not in ("pp", "pp_vr"):
        raise ValueError(f"the reference follows pp and pp_vr, not "
                         f"{eng.policy!r}")
    slot = np.asarray(slot, np.int64)
    block = np.asarray(block, np.int64)
    if np.any(np.diff(block) < 0):
        raise ValueError("events must be in block order")
    q_all = torch.from_numpy(np.asarray(q, np.float32))
    t_all = torch.from_numpy(np.asarray(t, np.float32))
    u_np = uniforms(rng_words, entity, t)
    u_all = torch.from_numpy(u_np)
    n, T = slot.size, len(eng.taus)
    d = dtype
    taus = torch.tensor(eng.taus, dtype=torch.float32)
    last_t = torch.full((n_slots,), -torch.inf)
    v_f = torch.zeros(n_slots, dtype=d)
    agg = torch.zeros((n_slots, T, 3), dtype=d)
    z_out = torch.zeros(n, dtype=torch.bool)
    p_out = torch.zeros(n)
    lam_out = torch.zeros(n)
    f_out = torch.zeros((n, 4 * T))
    slot_t = torch.from_numpy(slot)
    bounds = np.flatnonzero(np.diff(block)) + 1
    for lo, hi in zip(np.r_[0, bounds], np.r_[bounds, n]):
        s = slot_t[lo:hi]
        q, t, u = q_all[lo:hi], t_all[lo:hi], u_all[lo:hi]
        # decision against the block-start rows
        lt = last_t[s]
        fresh = torch.isinf(lt)
        dt = torch.where(fresh, 0.0, torch.clamp_min(t - lt, 0.0))
        beta_tau = torch.where(fresh[:, None], 0.0,
                               torch.exp((-dt[:, None] / taus).to(d)))
        beta_h = torch.where(fresh, 0.0, torch.exp((-dt / eng.h).to(d)))
        agg_now = agg[s] * beta_tau[..., None]
        cnt, sm, sq = agg_now[..., 0], agg_now[..., 1], agg_now[..., 2]
        cnt_f = torch.clamp_min(cnt, 1e-12)
        mean = sm / cnt_f
        var = torch.clamp_min(sq / cnt_f - mean * mean, 0.0)
        feats = torch.cat([cnt, sm, mean, torch.sqrt(var)], dim=1)
        lam = (1.0 + beta_h * v_f[s]) / eng.h
        base = torch.clamp_max(eng.budget / torch.clamp_min(lam, 1e-30), 1.0)
        if eng.policy == "pp_vr":
            k = eng.mu_tau_index
            cold = cnt[:, k] < 1.0
            mu_w = torch.where(cold, 0.0, mean[:, k])
            sg = torch.where(cold, 1e8, torch.sqrt(var[:, k]) + 1e-8)
            zs = torch.clamp((q.to(d) - mu_w) / torch.clamp_min(sg, 1e-8),
                             -8.0, 8.0)
            b = torch.clamp(base, 1e-6, 1.0 - 1e-6)
            p = torch.where(base >= 1.0 - 1e-6, 1.0,
                            1.0 / (1.0 + (1.0 - b) / b
                                   * torch.exp(-eng.alpha * zs)))
        else:
            p = base
        p = torch.clamp(p, eng.min_p, 1.0)
        z = u < p.float()
        z_out[lo:hi], p_out[lo:hi], lam_out[lo:hi] = z, p.float(), lam.float()
        f_out[lo:hi] = feats.float()
        if not bool(z.any()):
            continue
        # fold of the block's persisted events at each key's t*
        sz, tz, qz = s[z], t[z], q[z].to(d)
        inv_p = 1.0 / p[z]
        t_star = torch.full((n_slots,), -torch.inf).scatter_reduce(
            0, sz, tz, "amax")
        keys = torch.unique(sz)
        dte = t_star[sz] - tz
        vf_add = torch.zeros(n_slots, dtype=d).index_add_(
            0, sz, inv_p * torch.exp((-dte / eng.h).to(d)))
        w = torch.stack([torch.ones_like(qz), qz, qz * qz], -1)
        contrib = (inv_p[:, None, None]
                   * torch.exp((-dte[:, None] / taus).to(d))[..., None]
                   * w[:, None, :])
        agg_add = torch.zeros((n_slots, T, 3), dtype=d).index_add_(
            0, sz, contrib)
        ts, lk = t_star[keys], last_t[keys]
        old = torch.isinf(lk)
        gap = torch.where(old, 0.0, ts - lk)
        keep_h = torch.where(old, 0.0, torch.exp((-gap / eng.h).to(d)))
        keep_tau = torch.where(old[:, None], 0.0,
                               torch.exp((-gap[:, None] / taus).to(d)))
        v_f[keys] = vf_add[keys] + keep_h * v_f[keys]
        agg[keys] = agg_add[keys] + agg[keys] * keep_tau[..., None]
        last_t[keys] = ts
    return Replay(u=u_np, z=z_out.numpy(), p=p_out.numpy(),
                  lam=lam_out.numpy(), features=f_out.numpy(),
                  last_t=last_t.numpy(), v_f=v_f.float().numpy(),
                  agg=agg.float().numpy(),
                  persisted=np.isfinite(last_t.numpy()))


def decide(eng: Engine, q, features, lam) -> np.ndarray:
    """Eq. 2 (``pp``) or Eq. 4 (``pp_vr``) in float64: the inclusion
    probability of events with marks ``q`` against rows with these
    features ([n, 4T]: count, sum, mean, std per window) and lambda-hat."""
    T = len(eng.taus)
    f = np.asarray(features, np.float64)
    lam = np.asarray(lam, np.float64)
    base = np.minimum(eng.budget / np.maximum(lam, 1e-30), 1.0)
    if eng.policy == "pp_vr":
        k = eng.mu_tau_index
        cold = f[:, k] < 1.0
        mu = np.where(cold, 0.0, f[:, 2 * T + k])
        sg = np.where(cold, 1e8, f[:, 3 * T + k] + 1e-8)
        zs = np.clip((np.asarray(q, np.float64) - mu) / np.maximum(sg, 1e-8),
                     -8.0, 8.0)
        b = np.clip(base, 1e-6, 1.0 - 1e-6)
        p = np.where(base >= 1.0 - 1e-6, 1.0,
                     1.0 / (1.0 + (1.0 - b) / b * np.exp(-eng.alpha * zs)))
    elif eng.policy == "pp":
        p = base
    else:
        raise ValueError(f"the reference follows pp and pp_vr, not "
                         f"{eng.policy!r}")
    return np.clip(p, eng.min_p, 1.0)


def _features(agg: np.ndarray) -> np.ndarray:
    """[n, T, 3] aggregates (count, sum, sum of squares) as [n, 4T]
    features: count, sum, mean and standard deviation per window."""
    cnt, sm, sq = agg[..., 0], agg[..., 1], agg[..., 2]
    c = np.maximum(cnt, 1e-12)
    mean = sm / c
    std = np.sqrt(np.maximum(sq / c - mean * mean, 0.0))
    return np.concatenate([cnt, sm, mean, std], axis=1)


class Expected(NamedTuple):
    """What the program should have reported, judged step by step."""
    u: np.ndarray          # [n] float32 uniforms
    p: np.ndarray          # [n] Eq. 2/4 on the row the program saw
    lam: np.ndarray        # [n] lambda-hat of the row the reference folded
    features: np.ndarray   # [n, 4T] the features of that row
    first: np.ndarray      # [n] bool: the event is in its key's first block
    last_t: np.ndarray     # [K] each key's last persisted time (-inf: none)
    row_t: np.ndarray      # [K] the time the key's final row is taken at
    v_f: np.ndarray        # [K] its v_f decayed to row_t
    agg: np.ndarray        # [K, T, 3] its aggregates decayed to row_t
    persisted: np.ndarray  # [K] bool: some event of the key persisted
    taus: tuple            # the windows and the KDE bandwidth
    h: float


def expect(eng: Engine, slot, entity, q, t, block, rng_words, n_slots: int,
           z, features, lam) -> Expected:
    """Judge a program's run of ``n_slots`` keys step by step (float64).

    The events (``slot``, ``entity``, ``q``, ``t``, ``block``) are as
    ``replay`` takes them, with every event of each key from empty rows
    on; ``z``, ``features`` and ``lam`` are the program's decisions and
    the rows it reported seeing.  Each key's row as a block began is read
    back from what the program reported at its last event of the block
    (count and sum; the sum of squares as ``count * (std^2 + mean^2)``;
    ``v_f`` as ``lam * h - 1``, all decayed to that event's time); the
    events it persisted fold into it with weights ``1/p`` (``p`` from
    ``decide`` on that row), and the result, decayed to each event of the
    key's next block, is what that block should report.  A key's first
    block should report empty rows.
    """
    T, h = len(eng.taus), eng.h
    taus = np.asarray(eng.taus, np.float64)
    slot = np.asarray(slot, np.int64)
    block = np.asarray(block, np.int64)
    n = slot.size
    q64 = np.asarray(q, np.float64)
    t64 = np.asarray(t, np.float32).astype(np.float64)
    z = np.asarray(z, bool)
    f_prog = np.asarray(features, np.float64)
    lam_prog = np.asarray(lam, np.float64)
    u = uniforms(rng_words, entity, t)
    p = decide(eng, q, f_prog, lam_prog)
    # (key, block) groups, each key's in stream order
    order = np.lexsort((np.arange(n), slot))
    s_o, b_o = slot[order], block[order]
    head = np.ones(n, bool)
    head[1:] = (s_o[1:] != s_o[:-1]) | (b_o[1:] != b_o[:-1])
    gid = np.cumsum(head) - 1
    starts = np.flatnonzero(head)
    G = starts.size
    ends = np.r_[starts[1:], n]
    g_slot = s_o[starts]
    key_first = np.ones(G, bool)
    key_first[1:] = g_slot[1:] != g_slot[:-1]
    # each block's starting row, read back at the key's last event in it
    a = order[ends - 1]
    t_a = t64[a]
    fa = f_prog[a]
    cnt_a, sm_a = fa[:, :T], fa[:, T:2 * T]
    mean_a, std_a = fa[:, 2 * T:3 * T], fa[:, 3 * T:]
    agg_a = np.stack([cnt_a, sm_a, np.maximum(cnt_a, 1e-12)
                      * (std_a * std_a + mean_a * mean_a)], -1)
    v_a = lam_prog[a] * h - 1.0
    # the fold of each block's persisted events at its t*
    pe = order[z[order]]
    ge = gid[z[order]]
    t_star = np.full(G, -np.inf)
    np.maximum.at(t_star, ge, t64[pe])
    wrote = np.isfinite(t_star)
    row_t = np.where(wrote, t_star, t_a)
    w = 1.0 / p[pe]
    dte = t_star[ge] - t64[pe]
    v_new = np.bincount(ge, w * np.exp(-dte / h), minlength=G)
    # the read-back row is decayed to t_a >= t*: lift it back to t*
    d_a = np.where(wrote, t_a - row_t, 0.0)
    v_new = np.where(wrote, v_new + v_a * np.exp(d_a / h), v_a)
    wd = w[:, None] * np.exp(-dte[:, None] / taus)
    wq = np.stack([np.ones_like(pe, np.float64), q64[pe], q64[pe] ** 2], -1)
    agg_new = np.empty((G, T, 3))
    for j in range(T):
        for c in range(3):
            agg_new[:, j, c] = np.bincount(ge, wd[:, j] * wq[:, c],
                                           minlength=G)
    agg_new = np.where(wrote[:, None, None],
                       agg_new
                       + agg_a * np.exp(d_a[:, None] / taus)[..., None],
                       agg_a)
    # what each event should report: its key's previous block's result
    prev = np.where(key_first[gid], 0, gid - 1)
    dt = np.maximum(t64[order] - row_t[prev], 0.0)
    live = ~key_first[gid]
    agg_e = np.where(live[:, None, None],
                     agg_new[prev] * np.exp(-dt[:, None] / taus)[..., None],
                     0.0)
    v_e = np.where(live, v_new[prev] * np.exp(-dt / h), 0.0)
    f_exp = np.empty((n, 4 * T))
    lam_exp = np.empty(n)
    first = np.empty(n, bool)
    f_exp[order] = _features(agg_e)
    lam_exp[order] = (1.0 + v_e) / h
    first[order] = ~live
    # each key's final row: the result of its last block
    last_g = np.flatnonzero(np.r_[key_first[1:], True])
    keys_last = np.full(n_slots, -1)
    keys_last[g_slot[last_g]] = last_g
    seen = keys_last >= 0
    kl = np.where(seen, keys_last, 0)
    last_t = np.full(n_slots, -np.inf)
    np.maximum.at(last_t, slot[z], t64[z])
    return Expected(
        u=u, p=p, lam=lam_exp, features=f_exp, first=first, last_t=last_t,
        row_t=np.where(seen, row_t[kl], -np.inf),
        v_f=np.where(seen, v_new[kl], 0.0),
        agg=np.where(seen[:, None, None], agg_new[kl], 0.0),
        persisted=np.isfinite(last_t), taus=tuple(eng.taus), h=h)


def score(weights: dict, features: np.ndarray, dtype=torch.float32
          ) -> np.ndarray:
    """The scorer: ``relu(x w1 + b1) w2 + b2`` over the signed-log
    features ``x = (sign(f) log1p|f| - mu) / sd``."""
    d = dtype
    w = {k: torch.as_tensor(np.asarray(v, np.float32)).to(d)
         for k, v in weights.items()}
    f = torch.from_numpy(np.asarray(features, np.float32)).to(d)
    x = (torch.log1p(f.abs()) * torch.sign(f) - w["mu"]) / w["sd"]
    h = torch.relu(x @ w["w1"] + w["b1"])
    return (h @ w["w2"] + w["b2"])[:, 0].float().numpy()


def decode_rows(raw: bytes, n_taus: int) -> np.ndarray:
    """Profile rows as the stores hold them: magic and window count
    (uint16), last_t and v_f (float64), the aggregates (float32, window
    major), then v_full and last_t_full (float64), little-endian, packed."""
    dt = np.dtype([("magic", "<u2"), ("n", "<u2"), ("last_t", "<f8"),
                   ("v_f", "<f8"), ("agg", "<f4", (n_taus, 3)),
                   ("v_full", "<f8"), ("last_t_full", "<f8")])
    return np.frombuffer(raw, dt)
