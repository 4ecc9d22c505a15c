"""Vectorized persistence-path-control feature engine (paper §5), PyTorch.

The counterpart of ``repro.core.engine``, with the same two modes:

* ``exact`` — per-event sequential semantics.  Events are sorted by
  (key, t) and processed in *rounds*: round r handles every key's r-th event,
  so every round is a conflict-free scatter.  The default ``compact``
  schedule re-packs the sorted lanes into single-round chunks of
  ``exact_chunk`` lanes and walks only the ceil(B/C) + exact_rounds chunks
  that can be non-empty; ``masked`` runs every round over all B lanes.
  Decisions and state are bitwise those of the JAX engine.  Events of a key
  beyond ``exact_rounds`` in one batch are dropped, as in the reference:
  size ``exact_rounds`` to the stream's maximum events per key per batch.
* ``fast`` — decisions for the whole micro-batch against the batch-start
  state, then a closed-form segment fold of the persisted contributions.
  Decisions from a shared state are bitwise those of the JAX engine; the
  fold uses ``torch.exp`` and segment sums in another order, so the state
  agrees to a tolerance.

Both modes route the §5.1 decision + read-modify-write through
``repro_torch.kernels.ops.thinning_rmw`` (the CUDA kernel on the card, the
plain version on the CPU).  The steps update the state **in place** and
return it.  Nothing on the per-chunk or per-block path waits for the
device: no ``nonzero``, ``.item()``, boolean indexing or ``unique``.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core import estimators, intensity, thinning
from repro_torch.core.types import (Event, EngineConfig, ProfileState,
                                    StepInfo, init_state)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import FRESH_SENTINEL, cpu_flush_denormals

__all__ = ["init_state", "make_step", "materialize_features"]

_INT32_MAX = 2 ** 31 - 1

# Per-event RNG counter (shared definition in core.thinning).
_seq_bits = thinning.time_bits


def _fused_kw(cfg: EngineConfig) -> dict:
    """Kernel parameters derived from the engine config."""
    return dict(h=cfg.h, budget=cfg.budget, alpha=cfg.alpha,
                policy=cfg.policy, fixed_rate=cfg.fixed_rate,
                mu_tau_index=cfg.mu_tau_index, min_p=cfg.min_p)


def _taus(cfg: EngineConfig, device) -> torch.Tensor:
    return _taus_on(cfg.taus, torch.device(device))


@functools.lru_cache(maxsize=None)
def _taus_on(taus: tuple, device: torch.device) -> torch.Tensor:
    # one host-to-device copy per (taus, device), not one per step: a copy
    # from pageable host memory would wait for the device
    return torch.tensor(taus, dtype=torch.float32, device=device)


def _gather_rows(state: ProfileState, key: torch.Tensor):
    """Gather one profile row per event, sentinel-mapped for the kernel.

    Returns (last_t, v_f, agg_flat[B, 3T], v_full, last_t_full).
    """
    fin = lambda x: torch.where(torch.isfinite(x), x, FRESH_SENTINEL)
    take = lambda x: torch.index_select(x, 0, key)
    return (fin(take(state.last_t)), take(state.v_f),
            take(state.agg).reshape(key.shape[0], -1),
            take(state.v_full), fin(take(state.last_t_full)))


def _fused_rmw(cfg: EngineConfig, taus, state: ProfileState, key, q, t, u,
               valid):
    """One fused decision+update pass over gathered rows (whole profile row)."""
    last_t, v_f, agg_flat, v_full, last_t_full = _gather_rows(state, key)
    return ops.thinning_rmw(
        taus, last_t, v_f, agg_flat, q.contiguous(), t.contiguous(),
        u.contiguous(), valid.to(torch.float32), v_full, last_t_full,
        **_fused_kw(cfg))


def _scatter_where(columns, idx: torch.Tensor, mask: torch.Tensor) -> None:
    """``dst[idx[mask]] = val[mask]`` for each ``(dst, val)`` in ``columns``.

    torch has no 'drop' scatter mode and boolean indexing waits for the
    device, so lanes outside ``mask`` are pointed at the first masked lane
    and carry its value: duplicate indices then write identical bytes.  A
    spare lane covers the case of no masked lane at all — it rewrites
    ``dst[idx[0]]`` with its own value.  Masked indices must be distinct.
    """
    B = idx.shape[0]
    lanes = torch.arange(B, device=idx.device)
    rep = torch.argmax(torch.cat([mask, mask.new_ones(1)]).to(torch.uint8))
    src = torch.where(mask, lanes, rep)
    ext_idx = torch.cat([idx, idx[:1]])
    target = ext_idx[src]
    for dst, val in columns:
        ext_val = torch.cat([val, dst[idx[:1]]])
        dst[target] = ext_val[src]


def _scatter_rows(state: ProfileState, key, z, active, new_agg, new_v_f,
                  t, new_v_full) -> None:
    """Conflict-free in-place scatter of one round's kernel outputs:
    persisted columns where ``z``, the control column where ``active``."""
    n_taus = state.num_taus
    _scatter_where(((state.agg, new_agg.reshape(-1, n_taus, 3)),
                    (state.v_f, new_v_f), (state.last_t, t)), key, z)
    _scatter_where(((state.v_full, new_v_full), (state.last_t_full, t)),
                   key, active)


def _sort_by_key_time(ev: Event):
    # Invalid (padding) lanes sort into their own trailing segment, so a
    # padded tail's key=0/t=0 filler never takes entity 0's round slots.
    sort_key = torch.where(ev.valid, ev.key, _INT32_MAX)
    by_t = torch.argsort(ev.t, stable=True)          # lexsort: t, then key
    order = by_t[torch.argsort(sort_key[by_t], stable=True)]
    ev_s = Event(*(x[order] for x in ev))
    key_s = sort_key[order]
    idx = torch.arange(ev.key.shape[0], device=ev.key.device)
    is_start = torch.cat([key_s.new_ones(1, dtype=torch.bool),
                          key_s[1:] != key_s[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    round_id = idx - seg_start  # position within (key)-segment
    return ev_s, order, round_id


def _compact_schedule(round_id, valid_s, rounds: int, chunk: int):
    """Re-pack sorted lanes into single-round chunks of ``chunk`` lanes.

    Returns an int64 [n_chunks, chunk] table of sorted-lane indices (B marks
    an empty slot).  Each round's lanes are contiguous and padded to a chunk
    multiple, so a chunk never spans two rounds; sum_r ceil(n_r/C) <=
    floor(B/C) + rounds bounds the static chunk count.
    """
    B = round_id.shape[0]
    dev = round_id.device
    n_chunks = -(-B // chunk) + rounds
    rid = torch.where(valid_s & (round_id < rounds), round_id, rounds)
    comp = torch.argsort(rid, stable=True)        # keeps lane order
    rid_c = rid[comp]
    counts = torch.zeros(rounds + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, rid_c, torch.ones_like(rid_c))   # bincount
    counts = counts[:rounds]
    start = torch.cumsum(counts, 0) - counts      # exclusive, per round
    padded = (counts + chunk - 1) // chunk * chunk
    poff = torch.cumsum(padded, 0) - padded
    rid_cl = torch.clamp_max(rid_c, rounds - 1)
    slot = torch.where(rid_c < rounds,
                       poff[rid_cl] + (torch.arange(B, device=dev)
                                       - start[rid_cl]),
                       n_chunks * chunk)
    # one spare slot at the end takes the dropped lanes
    lane_of_slot = torch.full((n_chunks * chunk + 1,), B, dtype=torch.int64,
                              device=dev)
    lane_of_slot[slot] = comp
    return lane_of_slot[:-1].reshape(n_chunks, chunk)


def _step_exact(cfg: EngineConfig, impl: str, chunk: int, state: ProfileState,
                ev: Event, rng, rng_entity=None):
    dev = state.device
    taus = _taus(cfg, dev)
    ev = ev._replace(key=ev.key.to(torch.int64))
    ent = ev.key if rng_entity is None else rng_entity
    ev_s, order, round_id = _sort_by_key_time(ev)
    B = ev.key.shape[0]
    n_taus = taus.shape[0]

    # Round-invariant bookkeeping: the uniforms depend only on (entity, t),
    # the inverse permutation only on the batch.
    u_s = thinning.uniform_for_events(rng, ent[order], _seq_bits(ev_s.t))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(B, device=dev)

    # Per-event outputs in sorted-lane order, with a spare slot B that
    # takes the writes of inactive lanes.
    p_o = torch.zeros(B + 1, dtype=torch.float32, device=dev)
    z_o = torch.zeros(B + 1, dtype=torch.bool, device=dev)
    lam_o = torch.zeros(B + 1, dtype=torch.float32, device=dev)
    feats_o = torch.zeros((B + 1, 4 * n_taus), dtype=torch.float32,
                          device=dev)

    if impl == "compact":
        schedule = _compact_schedule(round_id, ev_s.valid, cfg.exact_rounds,
                                     max(8, min(chunk, B)))
        for lanes in schedule:
            # each chunk gathers only its (single-round) active lanes
            active = lanes < B
            lane = torch.where(active, lanes, 0)
            key = torch.where(active, ev_s.key[lane], 0)
            t_lane = ev_s.t[lane]
            (_, new_v_f, new_agg, z, p, feats, lam, new_v_full, _) = \
                _fused_rmw(cfg, taus, state, key, ev_s.q[lane], t_lane,
                           u_s[lane], active)
            _scatter_rows(state, key, z, active, new_agg, new_v_f, t_lane,
                          new_v_full)
            out_lane = torch.where(active, lane, B)
            p_o[out_lane] = p
            z_o[out_lane] = z
            lam_o[out_lane] = lam
            feats_o[out_lane] = feats
    else:  # 'masked' — every round over all B lanes
        p_o, z_o, lam_o, feats_o = p_o[:B], z_o[:B], lam_o[:B], feats_o[:B]
        for r in range(cfg.exact_rounds):
            active = (round_id == r) & ev_s.valid
            key = torch.where(active, ev_s.key, 0)
            (_, new_v_f, new_agg, z, p, feats, lam, new_v_full, _) = \
                _fused_rmw(cfg, taus, state, key, ev_s.q, ev_s.t, u_s,
                           active)
            _scatter_rows(state, key, z, active, new_agg, new_v_f, ev_s.t,
                          new_v_full)
            p_o = torch.where(active, p, p_o)
            z_o = z_o | z
            lam_o = torch.where(active, lam, lam_o)
            feats_o = torch.where(active[:, None], feats, feats_o)

    info = StepInfo(z=z_o[:B][inv] & ev.valid, p=p_o[:B][inv],
                    lam_hat=lam_o[:B][inv], features=feats_o[:B][inv],
                    writes=z_o[:B].sum().to(torch.int32))
    return state, info


def _step_fast(cfg: EngineConfig, state: ProfileState, ev: Event, rng,
               rng_entity=None):
    dev = state.device
    taus = _taus(cfg, dev)
    num_e = state.num_entities
    key = ev.key.to(torch.int64)
    ent = key if rng_entity is None else rng_entity
    safe_key = torch.where(ev.valid, key, 0)

    # Decision stage: one fused pass against the batch-start state; only
    # its decision outputs are used — the fold below subsumes its RMW.
    u = thinning.uniform_for_events(rng, torch.where(ev.valid, ent, 0),
                                    _seq_bits(ev.t))
    (_, _, _, z, p, feats, lam, _, _) = _fused_rmw(
        cfg, taus, state, safe_key, ev.q, ev.t, u, ev.valid)

    # --- closed-form segment fold of persisted contributions -------------
    # Scratch tables have a spare row num_e for the lanes that do not
    # contribute.  Segment sums use index_put_(accumulate=True): on CUDA
    # it sorts the indices and sums in a fixed order (no float atomics),
    # so two runs give identical state; on the CPU it would add with
    # atomics across threads, so it runs on one thread there.
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
    t_star = seg_max(data_idx, ev.t)        # last persisted time per key
    wrote = torch.isfinite(t_star)
    t_ref = torch.where(wrote, t_star, 0.0)

    inv_p = torch.where(z, torch.reciprocal(p), 0.0)
    dt_ev = t_ref[safe_key] - ev.t
    # v_f: sum_i (1/p_i) exp(-(t* - t_i)/h) + decay(t* - last_t) * v_f
    v_add = seg_sum(data_idx, inv_p * intensity.decay(dt_ev, cfg.h))
    v_f_new = torch.where(
        wrote, v_add + intensity.decay(t_star - state.last_t, cfg.h)
        * state.v_f, state.v_f)

    # aggregates: same fold per tau/column
    beta_ev = intensity.decay(dt_ev[:, None], taus)          # [B, T]
    w = torch.stack([torch.ones_like(ev.q), ev.q, ev.q * ev.q], -1)
    contrib = inv_p[:, None, None] * beta_ev[:, :, None] * w[:, None, :]
    agg_new = torch.where(
        wrote[:, None, None],
        seg_sum(data_idx, contrib)
        + estimators.decay_to(state.agg, state.last_t, t_star, taus),
        state.agg)
    last_t_new = torch.where(wrote, t_star, state.last_t)

    # full-stream control column (every valid event)
    ctrl_idx = torch.where(ev.valid, key, num_e)
    tf_star = seg_max(ctrl_idx, ev.t)
    saw = torch.isfinite(tf_star)
    tf_ref = torch.where(saw, tf_star, 0.0)
    w_full = torch.where(ev.valid, 1.0, 0.0) * intensity.decay(
        tf_ref[safe_key] - ev.t, cfg.h)
    v_full_new = torch.where(
        saw, seg_sum(ctrl_idx, w_full)
        + intensity.decay(tf_star - state.last_t_full, cfg.h) * state.v_full,
        state.v_full)
    last_t_full_new = torch.where(saw, tf_star, state.last_t_full)

    for dst, new in ((state.last_t, last_t_new), (state.v_f, v_f_new),
                     (state.agg, agg_new), (state.v_full, v_full_new),
                     (state.last_t_full, last_t_full_new)):
        dst.copy_(new)
    info = StepInfo(z=z, p=p, lam_hat=lam, features=feats,
                    writes=z.sum().to(torch.int32))
    return state, info


def make_step(cfg: EngineConfig, mode: str = "exact", *,
              exact_impl: str = "compact", exact_chunk: int = 256) -> Callable:
    """Build an engine step: (state, Event, rng) -> (state, StepInfo).

    The step updates ``state``'s tensors in place and returns the same
    state; it runs on the state's device.  ``rng`` is a key
    (``core.thinning.prng_key``).  The step also accepts an optional
    ``rng_entity`` int [B] keyword: the entity ids fed to the counter RNG
    when ``Event.key`` is a local row index rather than the global id.
    ``exact_impl``: 'compact' (default) or 'masked' — bit-identical outputs.
    """
    if mode == "exact":
        if exact_impl not in ("compact", "masked"):
            raise ValueError(f"unknown exact_impl {exact_impl!r}")
        return functools.partial(_step_exact, cfg, exact_impl, exact_chunk)
    if mode == "fast":
        return functools.partial(_step_fast, cfg)
    raise ValueError(f"unknown mode {mode!r}")


def materialize_features(state: ProfileState, keys: torch.Tensor,
                         t: torch.Tensor, taus) -> torch.Tensor:
    """Read-only feature materialization (serving path)."""
    taus = torch.as_tensor(taus, dtype=torch.float32, device=state.device)
    agg_now = estimators.decay_to(state.agg[keys], state.last_t[keys], t,
                                  taus)
    return estimators.materialize(agg_now)
