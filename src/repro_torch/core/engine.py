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
  state, then a closed-form segment fold of the persisted contributions
  (``repro_torch.kernels.ops.segment_fold``).  Decisions from a shared
  state are bitwise those of the JAX engine; the fold uses ``torch.exp``
  (the card's ``expf``) and sums in another order, so the state agrees to
  a tolerance.

Both modes route the §5.1 decision + read-modify-write through
``repro_torch.kernels.ops.thinning_rmw_keyed`` (the CUDA kernel on the
card, the plain version on the CPU): it reads the rows at the keys and
draws the counter-RNG uniforms itself, so the fast step's decision stage is
one launch, and in exact mode it also writes each chunk's (or round's)
rows back, so a chunk is one launch.  On the card the fast fold is one
more kernel (two launches: the block's lanes ranked by row, then one
warp a row) that reads and writes only the rows the block's valid keys
name, with O(B) scratch and each key's sums in ascending lane order, so
that the result depends neither on the row ids nor on the table's size;
on the CPU it is the plain whole-table fold.  The steps update the state
**in place** and return it.  Nothing on the per-chunk or per-block path
waits for the device: no ``nonzero``, ``.item()``, boolean indexing or
``unique``.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core import estimators
from repro_torch.core.types import (Event, EngineConfig, ProfileState,
                                    StepInfo, init_state)
from repro_torch.kernels import ops

__all__ = ["init_state", "make_step", "materialize_features"]

_INT32_MAX = 2 ** 31 - 1


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
    ev_s, order, round_id = _sort_by_key_time(ev)
    ent_s = (ev_s.key if rng_entity is None
             else rng_entity.to(torch.int64)[order])
    B = ev.key.shape[0]
    n_taus = taus.shape[0]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(B, device=dev)

    # Per-event outputs in sorted-lane order; each event is active in one
    # chunk (round), whose launch writes its slot.
    out = (torch.zeros(B, dtype=torch.bool, device=dev),
           torch.zeros(B, dtype=torch.float32, device=dev),
           torch.zeros((B, 4 * n_taus), dtype=torch.float32, device=dev),
           torch.zeros(B, dtype=torch.float32, device=dev))
    rmw = functools.partial(ops.thinning_rmw_keyed, taus, state, ev_s.key,
                            ev_s.q, ev_s.t, rng=rng, ent=ent_s,
                            write_back=True, out=out, **_fused_kw(cfg))
    if impl == "compact":
        # each chunk is one round's lanes (B marks an empty slot)
        schedule = _compact_schedule(round_id, ev_s.valid, cfg.exact_rounds,
                                     max(8, min(chunk, B)))
        for lanes in schedule:
            rmw(ev_s.valid, lanes=lanes)
    else:  # 'masked' — every round over all B lanes
        rounds = torch.arange(cfg.exact_rounds, device=dev)
        active = (round_id[None, :] == rounds[:, None]) & ev_s.valid
        for r in range(cfg.exact_rounds):
            rmw(active[r])

    z_o, p_o, feats_o, lam_o = out
    info = StepInfo(z=z_o[inv] & ev.valid, p=p_o[inv], lam_hat=lam_o[inv],
                    features=feats_o[inv],
                    writes=z_o.sum().to(torch.int32))
    return state, info


def _step_fast(cfg: EngineConfig, state: ProfileState, ev: Event, rng,
               rng_entity=None):
    dev = state.device
    taus = _taus(cfg, dev)
    key = ev.key.to(torch.int64)
    ent = None if rng_entity is None else rng_entity.to(torch.int64)

    # Decision stage: one keyed pass against the batch-start state (rows,
    # uniforms and decisions in one launch); the fold below does the RMW.
    z, p, feats, lam = ops.thinning_rmw_keyed(
        taus, state, key, ev.q, ev.t, ev.valid, rng, ent, **_fused_kw(cfg))

    # Closed-form segment fold of the persisted contributions, in place,
    # into the rows the block touches (one kernel on the card: O(B)
    # scratch, each key's sums in lane order; the whole-table plain
    # version on the CPU).
    ops.segment_fold(taus, state, key, ev.q, ev.t, ev.valid, z, p, h=cfg.h)
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
