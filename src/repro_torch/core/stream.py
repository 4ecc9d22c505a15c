"""Block driver for the vectorized engine (PyTorch).

The counterpart of ``repro.core.stream``: the dense path, the write-behind
sink path, bounded residency and the pipelined plane.  The JAX driver scans
``[n_batches, B]`` event blocks through one jitted program with the state
as a donated carry; here a Python loop feeds the blocks to the engine step,
which updates the state **in place**.  So the state passed to
``run_stream`` is the state it returns, mutated: a caller that needs the
pre-stream state copies it first.  There is no jit and no donation; of the
JAX driver's aliasing contract only "every leaf owns its storage" remains,
which ``init_state`` guarantees.

The loop never waits for the device: each block's outputs stay on the
device until the caller (or the sink's flush thread) reads them.  With a
sink, the rows handed over after each flush group are gathered *copies*
of the state, so the flush thread's device-to-host conversion reads the
group's end-of-group rows while the next group updates the state.

Bounded residency (``run_stream(residency=...)``) replaces the dense
per-entity state with a slot-based resident set: per flush group the host
``ResidencyMap`` translates event keys to slots, misses are read from the
sink's stores (``pack_hydration``) and scattered into their slots before
the group runs (``hydrate_scatter``), and victims are recycled without any
device read-back — see ``streaming/residency.py`` for the contract.  The
step runs with ``Event.key`` holding slots and the global ids as the
counter RNG's entities, so decisions do not depend on the budget.

Pipelined execution (``run_stream(pipeline_depth=2)``): a *prep thread*
plans group g+1 (slot assignment with the map's vectorized batch take,
oversized-group splitting), issues its hydration reads through the sink's
epoch-gated lane (``WriteBehindSink.stage_epoch``) and packs its host
arrays into a staging *generation* of pinned host buffers, while group g
runs on the card.  Each generation's host-to-device copies run on a second
CUDA stream; an event recorded after them is what the compute stream
waits on before the group's first kernel, and what the prep thread waits
on before it refills that generation — a pinned buffer is never rewritten
while its copy may still be reading it.  ``pipeline_depth`` generations
exist (ping-pong at 2); a token pool bounds how many staged groups wait on
the ready queue.  The dispatch thread (the caller) only pops staged
groups, launches them and submits their outputs to the sink; it never
waits for the device.  ``pipeline_depth=1`` is the serial driver, byte for
byte.  On the CPU the staging is plain host tensors (no streams).
"""
from __future__ import annotations

import functools
import queue
import threading
from typing import Callable, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.engine import make_step
from repro_torch.core.thinning import prng_key
from repro_torch.core.types import EngineConfig, Event, ProfileState, StepInfo

__all__ = ["run_stream", "block_runner_for", "sink_step_for",
           "residency_step_for", "hydrate_scatter", "hydration_width",
           "pack_hydration", "merge_miss_rows"]


def _stack(outs: List, collect_info: bool):
    """Stack per-block outputs along a new leading block axis."""
    if collect_info:
        return StepInfo(*(torch.stack(f) for f in zip(*outs)))
    return torch.stack(outs)


def block_runner_for(step, collect_info: bool = True):
    """A block-loop driver for an engine step.

    ``step``: (state, Event, rng, *consts) -> (state, StepInfo).  The
    returned ``run(state, events[n_blocks, B], rng, *consts)`` feeds the
    blocks in order and returns ``(state, outs)``: a StepInfo stacked
    ``[n_blocks, B]`` (``collect_info=True``) or the per-block write counts.
    """
    def run(state: ProfileState, events: Event, rng, *consts):
        outs = []
        for b in range(events.key.shape[0]):
            state, info = step(state, Event(*(x[b] for x in events)), rng,
                               *consts)
            outs.append(info if collect_info else info.writes)
        return state, _stack(outs, collect_info)

    return run


def _group_outs(outs, collect_info):
    """Per-block step outputs -> the group's stacked StepInfo, or
    ``(z[G, B], writes[G])``."""
    if collect_info:
        return _stack(outs, True)
    return (torch.stack([o.z for o in outs]),
            torch.stack([o.writes for o in outs]))


def _gather_rows(state: ProfileState, gather_idx):
    """Post-update rows at ``gather_idx`` as copies: scalar columns stacked
    ``[last_t, v_f, v_full, last_t_full]``, then ``agg``."""
    take = lambda x: torch.index_select(x, 0, gather_idx)
    scal = torch.stack([take(state.last_t), take(state.v_f),
                        take(state.v_full), take(state.last_t_full)])
    return scal, take(state.agg)


def sink_step_for(step, collect_info: bool = True):
    """Per-flush-group driver for the write-behind persistence path.

    The returned callable is ``(state, events[G, B], rng, gather_idx[G*B],
    *consts) -> (state, outs, (scalars[4, G*B], agg[G*B, T, 3]))``: ``G``
    blocks run through ``step``, then the post-update profile rows at
    ``gather_idx`` are gathered — scalar columns stacked as ``[last_t, v_f,
    v_full, last_t_full]``.  The gathers are copies, never views of the
    state the next group updates.  ``outs`` is the stacked StepInfo, or
    ``(z[G, B], writes[G])`` when ``collect_info=False``.
    """
    def run(state: ProfileState, events: Event, rng, gather_idx, *consts):
        outs = []
        for b in range(events.key.shape[0]):
            state, info = step(state, Event(*(x[b] for x in events)), rng,
                               *consts)
            outs.append(info)
        return state, _group_outs(outs, collect_info), \
            _gather_rows(state, gather_idx)

    return run


def hydrate_scatter(state: ProfileState, slots, scal, agg,
                    m: int = None) -> ProfileState:
    """Scatter hydrated rows into resident slots, in place (the read half
    of bounded residency).

    ``slots``: int64 [H] state rows; ``scal``: [4, H] columns stacked
    ``[last_t, v_f, v_full, last_t_full]`` (the ``sink_step_for`` gather's
    order); ``agg``: [H, T, 3].  Only the first ``m`` lanes are scattered
    (all when ``m`` is None): ``pack_hydration`` puts the real lanes first
    and points the padding at the out-of-range slot ``n_slots``, which the
    JAX scatter drops and a torch index would fault on.  Values come
    straight from ``kvstore.SerDe.unpack_rows`` — an exact f32 round-trip
    of the engine state — or the ``init_state`` defaults for keys with no
    durable row, so hydration is bit-exact by construction.  Slots are
    distinct, so ``index_copy_`` lands each row once.
    """
    if m is not None:
        slots, scal, agg = slots[:m], scal[:, :m], agg[:m]
    if slots.shape[0]:
        for i, col in enumerate((state.last_t, state.v_f, state.v_full,
                                 state.last_t_full)):
            col.index_copy_(0, slots, scal[i])
        state.agg.index_copy_(0, slots, agg)
    return state


def residency_step_for(step, collect_info: bool = True):
    """``sink_step_for`` plus a hydration prologue for bounded residency.

    The returned callable is ``(state, events, rng, gather_idx, h_slots,
    h_scal, h_agg, m) -> (state, outs, rows)``: the first ``m`` hydrated
    rows are scattered into their slots (``hydrate_scatter``) *before* the
    group runs (misses of this flush group, read and packed by the host),
    then the group runs exactly like the sink path with ``Event.key``
    holding *slot* indices.  ``events`` is ``(Event[G, B], ent[G, B])``:
    ``step`` takes ``(state, (Event, ent), rng)`` so thinning stays keyed
    on the global entity ids ``ent``.
    """
    def run(state: ProfileState, events, rng, gather_idx, h_slots, h_scal,
            h_agg, m):
        state = hydrate_scatter(state, h_slots, h_scal, h_agg, m)
        ev, ent = events
        outs = []
        for b in range(ev.key.shape[0]):
            state, info = step(state, (Event(*(x[b] for x in ev)), ent[b]),
                               rng)
            outs.append(info)
        return state, _group_outs(outs, collect_info), \
            _gather_rows(state, gather_idx)

    return run


@functools.lru_cache(maxsize=None)
def _block_runner(cfg: EngineConfig, mode: str, collect_info: bool,
                  exact_impl: str):
    """One block-loop driver per (cfg, mode, flags)."""
    return block_runner_for(make_step(cfg, mode, exact_impl=exact_impl),
                            collect_info)


@functools.lru_cache(maxsize=None)
def _sink_step(cfg: EngineConfig, mode: str, collect_info: bool,
               exact_impl: str):
    """One per-flush-group sink-path driver per (cfg, mode, flags)."""
    return sink_step_for(make_step(cfg, mode, exact_impl=exact_impl),
                         collect_info)


@functools.lru_cache(maxsize=None)
def _residency_step(cfg: EngineConfig, mode: str, collect_info: bool,
                    exact_impl: str):
    """One hydrate + blocks + gather driver per (cfg, mode, flags): the
    core step takes ``(Event, rng_entity)`` pairs so ``Event.key`` can hold
    slot indices while thinning stays keyed on global entity ids."""
    step = make_step(cfg, mode, exact_impl=exact_impl)

    def estep(st, ev_ent, rng):
        ev, ent = ev_ent
        return step(st, ev, rng, rng_entity=ent)

    return residency_step_for(estep, collect_info)


def hydration_width(m: int) -> int:
    """Padded hydration width for ``m`` miss rows: the next power of two
    (minimum 1).  Shared by ``pack_hydration`` and the staging buffers."""
    return 1 << max(int(m) - 1, 0).bit_length() if m else 1


def pack_hydration(rows, miss_slots, serde, n_slots: int, n_taus: int,
                   width: int = None):
    """Decode one group's hydration reads into scatter-ready host arrays.

    ``rows``: ``ReadTicket.result()`` output aligned with the miss keys
    (``None`` for keys with no durable row — they get the ``init_state``
    defaults, matching a never-persisted entity).  Returns ``(h_slots[H],
    h_scal[4, H], h_agg[H, T, 3])`` with ``H`` the next power of two of
    the miss count and padding lanes pointed at the out-of-range slot
    ``n_slots`` — the JAX package's arrays, value for value.  The real
    lanes come first; ``hydrate_scatter`` scatters only those.  ``width``
    overrides ``H`` (must be >= the miss count).
    """
    m = len(miss_slots)
    H = hydration_width(m) if width is None else int(width)
    h_slots = np.full(H, n_slots, np.int32)
    h_scal = np.zeros((4, H), np.float32)
    h_scal[0] = -np.inf                     # last_t init
    h_scal[3] = -np.inf                     # last_t_full init
    h_agg = np.zeros((H, n_taus, 3), np.float32)
    if m:
        h_slots[:m] = miss_slots
        present = [i for i, r in enumerate(rows) if r is not None]
        if present:
            lt, vf, ag, vfl, ltf = serde.unpack_rows(
                [rows[i] for i in present])
            idx = np.asarray(present)
            h_scal[0, idx] = lt.astype(np.float32)
            h_scal[1, idx] = vf.astype(np.float32)
            h_scal[2, idx] = vfl.astype(np.float32)
            h_scal[3, idx] = ltf.astype(np.float32)
            h_agg[idx] = ag
    return h_slots, h_scal, h_agg


def merge_miss_rows(fresh_mask, rows_fresh, rows_re):
    """Re-interleave the two read lanes' rows back into miss order."""
    it_f, it_r = iter(rows_fresh), iter(rows_re)
    return [next(it_f) if f else next(it_r) for f in fresh_mask]


class _GroupPlan(NamedTuple):
    """One flush group's host-side dispatch plan (residency drivers)."""
    # host [G, B] arrays: key (slots; also the sink gather rows), q, t,
    # valid, ent (global ids, the counter RNG's entities)
    events: dict
    sink_keys: np.ndarray   # flat global entity ids (sink row keys)
    valid: np.ndarray       # flat padding mask
    # hydration reads, split by ordering need: first-touch keys (no flush
    # of this run can hold them -> the sink's unordered lane) vs
    # rehydrations (must ride the FIFO behind earlier flushes)
    fresh_keys: np.ndarray
    rehydrate_keys: np.ndarray
    build_hydration: Callable  # (rows_fresh, rows_re) -> (h_slots, ...)
    # False on all but the final sub-group of a split oversized flush
    # group (``streaming.residency.split_oversized_group``)
    last: bool = True

    @property
    def misses(self) -> int:
        return len(self.fresh_keys) + len(self.rehydrate_keys)


class _Stager:
    """Host arrays -> device tensors for one group, in generations.

    On CUDA each generation owns pinned host buffers (grown on demand) and
    the event recorded after its last copies, which run on ``copy_stream``
    with ``non_blocking=True``.  ``stage`` waits for a generation's event
    before refilling it, so a pinned buffer is never rewritten while its
    copy may still read it; the consumer makes the compute stream wait on
    the returned event (``_consume``).  The serial driver stages through
    one generation, the pipelined ones through ``pipeline_depth``.  On the
    CPU it copies into fresh tensors.
    """

    def __init__(self, device: torch.device, generations: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self._bufs = [dict() for _ in range(generations)]
        self._done = [None] * generations
        self._next = 0

    def _buffer(self, g: int, name: str, a: np.ndarray) -> torch.Tensor:
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        buf = self._bufs[g].get(name)
        if buf is None or buf.dtype != dtype or buf.numel() < a.size:
            buf = torch.empty(max(a.size, 1), dtype=dtype, pin_memory=True)
            self._bufs[g][name] = buf
        view = buf[:a.size].view(a.shape)
        view.numpy()[...] = a
        return view

    def stage(self, arrays: dict):
        """Copy ``arrays`` (name -> numpy) to the device: returns (name ->
        tensor, event or None)."""
        if not self.cuda:
            return {k: torch.from_numpy(np.array(a)).to(self.device)
                    for k, a in arrays.items()}, None
        g = self._next
        self._next = (g + 1) % len(self._bufs)
        if self._done[g] is not None:
            self._done[g].synchronize()     # its last copies have landed
        with torch.cuda.stream(self.copy_stream):
            out = {k: self._buffer(g, k, a).to(self.device, non_blocking=True)
                   for k, a in arrays.items()}
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        self._done[g] = done
        return out, done


def _consume(staged, done, device):
    """Make the compute stream wait for a generation's copies and keep the
    copied tensors' memory until the compute stream is done with them."""
    if done is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        for x in staged.values():
            x.record_stream(stream)
    return staged


def _hydration_arrays(plan: _GroupPlan, h) -> dict:
    h_slots, h_scal, h_agg = h
    return {**plan.events, "h_slots": h_slots.astype(np.int64),
            "h_scal": h_scal, "h_agg": h_agg}


def _run_planned(bstep, state, plan: _GroupPlan, d: dict, rng):
    """Launch one planned group on its staged tensors ``d``."""
    ev = Event(key=d["key"], q=d["q"], t=d["t"], valid=d["valid"])
    return bstep(state, (ev, d["ent"]), rng, d["key"].reshape(-1),
                 d["h_slots"], d["h_scal"], d["h_agg"], plan.misses)


@tracing.entry
def run_stream(cfg: EngineConfig, state: ProfileState, keys, qs, ts,
               *, batch: int = 4096, mode: str = "fast",
               rng=None, collect_info: bool = True,
               exact_impl: str = "compact", sink=None, sink_group: int = 4,
               residency=None, pipeline_depth: int = 1
               ) -> Tuple[ProfileState, Union[StepInfo, torch.Tensor]]:
    """Drive the engine over a flat stream in ``[n_batches, batch]`` blocks.

    keys/qs/ts: flat [N] host arrays; the tail is padded with invalid
    events to a full block.  Runs on the state's device and updates the
    state in place.  Returns the state plus either a flat StepInfo trimmed
    back to N events (``collect_info=True``) or the per-block write counts
    [n_batches] (``collect_info=False``).  ``rng`` is a key
    (``core.thinning.prng_key``; default ``prng_key(0)``).

    ``sink``: an optional ``streaming.persistence.WriteBehindSink`` on the
    state's device.  The stream then runs in flush groups of ``sink_group``
    blocks and each group's decisions and post-update rows are submitted
    for write-behind flush; the sink's threads convert and store them
    while the next group computes.  The caller owns the sink: call
    ``sink.flush()`` (or close it) to wait for the trailing groups.

    ``residency``: an int slot budget ``S`` or a prebuilt
    ``streaming.residency.ResidencyMap``.  The state then holds ``S``
    *slots* (``init_state(S, ...)``), event keys are translated to slots
    per flush group, misses are hydrated from the sink's stores (first
    touches on the unordered lane, rehydrations behind earlier flushes; a
    sink with ``l2=`` answers from its host tier first) and victims are
    recycled per the map's eviction policy and demoted into the L2 tier.
    A flush group with more distinct keys than slots is split into
    key-complete sub-groups that each fit.  Requires ``sink``; ``z``/``p``/
    features and stored bytes do not depend on the budget.

    ``pipeline_depth``: ``1`` is the serial flush-group loop; ``>= 2``
    runs the pipelined plane (module docstring), bit-identical to it.
    Requires a sink; with residency, a threaded sink with
    ``overflow="block"``.
    """
    depth = int(pipeline_depth)
    if depth < 1:
        raise ValueError("pipeline_depth must be >= 1")
    if depth > 1 and sink is None:
        raise ValueError(
            "pipeline_depth > 1 requires a sink: the pipelined plane "
            "overlaps host group prep with device compute across flush "
            "groups, which the block loop without a sink does not have")
    if rng is None:
        rng = prng_key(0)
    dev = state.device
    if sink is not None and sink.device != dev:
        raise ValueError(f"the sink is for {sink.device} but the state "
                         f"lives on {dev}")
    n = int(np.shape(keys)[0])
    pad = (-n) % batch
    host_blocks = lambda x, fill: np.reshape(
        np.pad(np.asarray(x), (0, pad), constant_values=fill), (-1, batch))
    key_h = host_blocks(np.asarray(keys, np.int32), 0)
    q_h = host_blocks(np.asarray(qs, np.float32), 0.0)
    t_h = host_blocks(np.asarray(ts, np.float32), 0.0)
    valid_h = host_blocks(np.ones(n, bool), False)
    n_blocks, group = key_h.shape[0], max(1, int(sink_group))

    if n_blocks == 0:
        info = _concat_groups([], collect_info, len(cfg.taus), dev)
    elif residency is not None:
        from repro_torch.streaming.residency import (ResidencyMap,
                                                     split_oversized_group)
        if sink is None:
            raise ValueError(
                "residency requires a write-behind sink: evicted slots "
                "rely on the durable store for rehydration")
        if isinstance(residency, ResidencyMap):
            rmap = residency
        else:
            rmap = ResidencyMap(int(np.max(key_h)) + 1, int(residency))
        if state.num_entities != rmap.n_slots:
            raise ValueError(
                f"state holds {state.num_entities} rows but the resident "
                f"set has {rmap.n_slots} slots; build it with "
                f"init_state(n_slots, ...)")
        bstep = _residency_step(cfg, mode, collect_info, exact_impl)
        serde, n_taus = sink.serde, state.num_taus

        def plan_group(lo, hi):
            kseg, vseg = key_h[lo:hi], valid_h[lo:hi]
            # a group with more distinct keys than slots is split into
            # key-complete sub-groups that each fit; they run the same
            # [G, B] blocks with restricted valid masks and flush as
            # separate sink batches (per-key FIFO order is kept)
            segs = split_oversized_group(kseg, vseg, rmap.n_slots)
            if len(segs) > 1:
                rmap.stats.splits += len(segs) - 1
            plans = []
            for j, vmask in enumerate(segs):
                vm = vmask.reshape(kseg.shape)
                asn = rmap.assign_group(kseg, vm, batch_take=depth > 1)
                # victims leave the slot plane -> host L2 tier (a recency
                # refresh only; safe before any sub-group's flush)
                sink.demote(asn.evicted)
                slots = asn.slot.reshape(kseg.shape)

                def build(rows_fresh, rows_re, asn=asn):
                    rows = merge_miss_rows(asn.miss_fresh, rows_fresh,
                                           rows_re)
                    return pack_hydration(rows, asn.miss_slots, serde,
                                          rmap.n_slots, n_taus)

                # rng entity ids: the raw key blocks (padding lanes are 0;
                # the engine masks invalid lanes itself)
                plans.append(_GroupPlan(
                    dict(key=slots.astype(np.int64), q=q_h[lo:hi],
                         t=t_h[lo:hi], valid=vm, ent=kseg.astype(np.int64)),
                    kseg.reshape(-1), vmask.reshape(-1),
                    asn.miss_keys[asn.miss_fresh],
                    asn.miss_keys[~asn.miss_fresh], build,
                    last=j == len(segs) - 1))
            return plans

        state, info = _drive_with_residency(
            bstep, state, n_blocks, group, plan_group, rng, sink,
            collect_info=collect_info, pipeline_depth=depth)
        info = _concat_groups(info, collect_info, len(cfg.taus), dev)
    elif sink is not None:
        run_group = _sink_step(cfg, mode, collect_info, exact_impl)
        group_of = group_source(dict(key=key_h.astype(np.int64), q=q_h,
                                     t=t_h, valid=valid_h), dev, depth)
        state, info = _drive_with_sink(
            run_group, state, n_blocks, group, group_of, rng, sink,
            sink_keys=key_h, valid_host=valid_h, collect_info=collect_info,
            pipeline_depth=depth)
        info = _concat_groups(info, collect_info, len(cfg.taus), dev)
    else:
        events = Event(*(torch.from_numpy(x).to(dev)
                         for x in (key_h.astype(np.int64), q_h, t_h,
                                   valid_h)))
        state, info = _block_runner(cfg, mode, collect_info, exact_impl)(
            state, events, rng)
    if not collect_info:
        return state, info
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))[:n]
    return state, StepInfo(
        z=flat(info.z), p=flat(info.p), lam_hat=flat(info.lam_hat),
        features=flat(info.features),
        writes=info.writes.sum().to(torch.int32))


def group_source(blocks: dict, device, depth: int):
    """``group_of(lo, hi)`` over ``[n_blocks, B]`` host blocks for the sink
    drivers: the serial driver gets slices of one whole-stream copy on the
    device, the pipelined one host slices that its prep thread stages."""
    if depth == 1:
        with tracing.span("stream.stage"):
            blocks = {k: torch.from_numpy(x).to(device)
                      for k, x in blocks.items()}
    return lambda lo, hi: {k: x[lo:hi] for k, x in blocks.items()}


def _sink_event(d: dict):
    ev = Event(key=d["key"], q=d["q"], t=d["t"], valid=d["valid"])
    return ev, d["key"].reshape(-1)


def _drive_with_sink(bstep, state, n_blocks, group, group_of, rng, sink, *,
                     sink_keys, valid_host, collect_info, consts=(),
                     pipeline_depth=1):
    """Host flush-group loop for the write-behind path (shared with the
    feature engine).  ``group_of(lo, hi)`` returns the group's ``[G, B]``
    arrays (key = the state rows the group runs on, q, t, valid): device
    tensors for the serial loop, host arrays for the pipelined one
    (``group_source``); the gather rows are the keys.  ``sink_keys``:
    ``[n_blocks, B]`` global entity ids.  The driver only launches and enqueues: the
    device-to-host conversion happens on the sink's flush thread.
    Returns (state, per-group outputs).

    ``pipeline_depth >= 2`` delegates to ``_drive_pipelined_sink``.
    """
    if pipeline_depth > 1:
        return _drive_pipelined_sink(
            bstep, state, n_blocks, group, group_of, rng, sink,
            sink_keys=sink_keys, valid_host=valid_host,
            collect_info=collect_info, consts=consts, depth=pipeline_depth)
    outs_all = []
    for lo in range(0, n_blocks, group):
        hi = min(lo + group, n_blocks)
        with tracing.span("stream.group"):
            with tracing.span("stream.step"):
                ev, gidx = _sink_event(group_of(lo, hi))
                state, outs, rows = bstep(state, ev, rng, gidx, *consts)
            z = outs.z if collect_info else outs[0]
            sink.submit(sink_keys[lo:hi].reshape(-1), z,
                        valid_host[lo:hi].reshape(-1), rows)
        outs_all.append(outs)
    return state, outs_all


def _acquire(tokens, stop) -> bool:
    """Take a staging token, polling ``stop`` (False: shut down)."""
    while not tokens.acquire(timeout=0.1):
        if stop.is_set():
            return False
    if stop.is_set():
        tokens.release()
        return False
    return True


def _drive_pipelined_sink(bstep, state, n_blocks, group, group_of, rng,
                          sink, *, sink_keys, valid_host, collect_info,
                          depth, consts=()):
    """Pipelined write-behind driver: group staging overlaps dispatch.

    The prep thread builds each group's host arrays, stages them into a
    generation (copies on the copy stream) and parks the group on the
    ready queue; the dispatch thread (the caller) pops it, makes the
    compute stream wait for its copies, launches and submits.  There are
    no hydration reads on this path, so no epoch gating is needed;
    flushes ride the sink queue in dispatch order.
    """
    dev = state.device
    stager = _Stager(dev, depth)
    ready: queue.Queue = queue.Queue()
    tokens = threading.BoundedSemaphore(depth)
    stop = threading.Event()

    def prep():
        try:
            for lo in range(0, n_blocks, group):
                hi = min(lo + group, n_blocks)
                if not _acquire(tokens, stop):
                    return
                with sink.overlap.host():
                    staged, done = stager.stage(group_of(lo, hi))
                ready.put(("group", lo, hi, staged, done))
            ready.put(("done",))
        except BaseException as e:   # surfaced on the dispatch thread
            ready.put(("error", e))

    th = threading.Thread(target=prep, name="pipeline-prep", daemon=True)
    th.start()
    outs_all = []
    try:
        while True:
            item = ready.get()
            if item[0] == "done":
                break
            if item[0] == "error":
                raise item[1]
            _, lo, hi, staged, done = item
            # the generation's own event guards its buffers; the token
            # only bounds how far prep runs ahead
            tokens.release()
            with tracing.span("stream.group"):
                with sink.overlap.device(), tracing.span("stream.step"):
                    ev, gidx = _sink_event(_consume(staged, done, dev))
                    state, outs, rows = bstep(state, ev, rng, gidx, *consts)
                z = outs.z if collect_info else outs[0]
                sink.submit(sink_keys[lo:hi].reshape(-1), z,
                            valid_host[lo:hi].reshape(-1), rows)
            outs_all.append(outs)
    finally:
        stop.set()
        th.join()
    return state, outs_all


def _drive_with_residency(bstep, state, n_blocks, group, plan_group, rng,
                          sink, *, collect_info, pipeline_depth=1):
    """Hydrate→dispatch→evict flush-group schedule for bounded residency
    (shared with the feature engine via the ``plan_group`` callback).

    Per group g: wait on g's hydration reads, pack and upload the rows,
    scatter them and launch the group, hand its decisions and post-update
    rows to the sink, then plan group g+1 (slot assignment and eviction on
    the host ResidencyMap) and submit its reads — which ride the sink's
    FIFO behind g's flush, so a rehydrated key always reads its latest
    durable row.  Eviction moves no device data: durable columns only
    change on persisted events, so the store already holds every victim's
    current row.

    ``plan_group(lo, hi)`` returns the ``_GroupPlan`` sub-groups for blocks
    [lo, hi) (more than one when the group was split); it must be called
    in stream order.  Sub-group k+1's reads are submitted only after
    sub-group k's flush.  ``pipeline_depth >= 2`` delegates to
    ``_drive_pipelined_residency``.  Returns (state, per-group outputs).
    """
    if pipeline_depth > 1:
        return _drive_pipelined_residency(
            bstep, state, n_blocks, group, plan_group, rng, sink,
            collect_info=collect_info, depth=pipeline_depth)

    def reads_of(plan):
        # first-touch misses skip the FIFO (nothing in flight can hold
        # them); rehydrations wait their turn behind earlier flushes
        return (sink.submit_read(plan.fresh_keys, ordered=False),
                sink.submit_read(plan.rehydrate_keys))

    stager = _Stager(state.device, 1)
    # drain what a previous run left in flight: the unordered lane's
    # safety argument covers only writes submitted after this point
    sink.flush()
    outs_all, part_outs = [], []
    with sink.overlap.host():
        pending = plan_group(0, min(group, n_blocks))
    next_lo = min(group, n_blocks)
    i = 0
    t_fresh, t_re = reads_of(pending[0])
    while True:
        plan = pending[i]
        with tracing.span("stream.group"):
            rows_f, rows_r = t_fresh.result(), t_re.result()
            with sink.overlap.host():
                h = plan.build_hydration(rows_f, rows_r)
                d = _consume(*stager.stage(_hydration_arrays(plan, h)),
                             state.device)
            with tracing.span("stream.step"):
                state, outs, rows = _run_planned(bstep, state, plan, d, rng)
            z = outs.z if collect_info else outs[0]
            sink.submit(plan.sink_keys, z, plan.valid, rows)
        part_outs.append((outs, d["valid"]))
        if plan.last:
            outs_all.append(_merge_subgroup_outs(part_outs, collect_info))
            part_outs = []
        i += 1
        if i == len(pending):
            if next_lo >= n_blocks:
                break
            with sink.overlap.host():
                pending = plan_group(next_lo, min(next_lo + group,
                                                  n_blocks))
            next_lo = min(next_lo + group, n_blocks)
            i = 0
        t_fresh, t_re = reads_of(pending[i])
    return state, outs_all


def _drive_pipelined_residency(bstep, state, n_blocks, group, plan_group,
                               rng, sink, *, collect_info, depth):
    """Pipelined hydrate→dispatch→evict driver (``pipeline_depth >= 2``).

    Thread split:

    * **prep thread** — in stream order: plan the group (slot assignment
      with the vectorized batch take, splitting, demotes), submit its
      hydration reads (first-touch misses on the unordered lane,
      rehydrations on the epoch-gated ``staged=True`` lane), *then*
      ``stage_epoch`` the group (reads first — a group must never gate on
      its own flush).  Reads are issued for up to ``depth`` groups before
      the oldest group's tickets are waited on.  Completion is
      oldest-first: wait the tickets, pack the hydration arrays, stage
      the group into a generation (copies on the copy stream) and park it
      on the ready queue.
    * **dispatch thread** (the caller) — pop, make the compute stream wait
      for the group's copies, launch, and ``submit(..., seq=epoch)`` so
      the epoch marker trails the group's puts on every partition.

    Ordering under overlap:

    * *per-key FIFO* — groups are planned, staged, launched and submitted
      in stream order (one prep thread, one FIFO ready queue, one
      dispatch thread); within a group the blocks run in order; splits
      are key-complete.
    * *evict→rehydrate reads the latest durable row* — a rehydration read
      of key k carries ``need = max staged epoch over its keys``; the
      store worker parks it until its partition has applied that epoch,
      i.e. until every flush staged before the read has executed its
      puts there.
    * *deadlock-freedom* — a parked read's need names an epoch staged
      before the read was submitted, hence a group at or before the one
      the dispatch thread is draining toward; the dispatch thread never
      waits on read tickets.  The prep thread's token wait polls ``stop``.
    * *staged buffers* — a generation is refilled only after the event of
      its previous copies has completed (``_Stager``).

    Requires a threaded sink with pure backpressure: the serial sink
    executes reads inline on the submitting thread and the degrade
    overflow policy flushes inline on the dispatch thread — both would
    break the one-thread-per-store invariant once a prep thread exists.
    """
    if getattr(sink, "_serial", False):
        raise ValueError(
            "pipeline_depth > 1 requires a threaded sink "
            "(WriteBehindSink queue_depth >= 1): the serial sink "
            "executes reads inline on the submitting thread")
    if getattr(sink, "_overflow", "block") != "block":
        raise ValueError(
            "pipeline_depth > 1 requires overflow='block': a degraded "
            "inline flush on the dispatch thread would race the prep "
            "thread's reads on the partition stores")
    dev = state.device
    sink.flush()   # same unordered-lane safety barrier as the serial driver
    stager = _Stager(dev, depth)
    ready: queue.Queue = queue.Queue()
    tokens = threading.BoundedSemaphore(depth)
    stop = threading.Event()

    def prep():
        inflight: list = []   # issued-but-unpacked groups, oldest first

        def complete_oldest():
            plan, t_fresh, t_re, seq = inflight.pop(0)
            rows_f, rows_r = t_fresh.result(), t_re.result()
            with sink.overlap.host():
                h = plan.build_hydration(rows_f, rows_r)
                staged, done = stager.stage(_hydration_arrays(plan, h))
            ready.put(("group", plan, staged, done, seq))

        try:
            for lo in range(0, n_blocks, group):
                hi = min(lo + group, n_blocks)
                with sink.overlap.host():
                    plans = plan_group(lo, hi)
                for plan in plans:
                    if not _acquire(tokens, stop):
                        return
                    # reads before stage_epoch: the group's own misses
                    # must not wait on the group's own (future) flush
                    t_fresh = sink.submit_read(plan.fresh_keys,
                                               ordered=False)
                    t_re = sink.submit_read(plan.rehydrate_keys,
                                            staged=True)
                    seq = sink.stage_epoch(plan.sink_keys, plan.valid)
                    inflight.append((plan, t_fresh, t_re, seq))
                    # drain before the token pool can block: when the
                    # acquire above parks, the ready queue is non-empty
                    # and the dispatch thread's next pop frees a token
                    if len(inflight) >= depth:
                        complete_oldest()
            while inflight:
                complete_oldest()
            ready.put(("done",))
        except BaseException as e:   # surfaced on the dispatch thread
            ready.put(("error", e))

    th = threading.Thread(target=prep, name="pipeline-prep", daemon=True)
    th.start()
    outs_all, part_outs = [], []
    try:
        while True:
            item = ready.get()
            if item[0] == "done":
                break
            if item[0] == "error":
                raise item[1]
            _, plan, staged, done, seq = item
            tokens.release()
            with tracing.span("stream.group"):
                # metered as device time: the launches hold the dispatch
                # thread for the window prep work can hide inside
                with sink.overlap.device(), tracing.span("stream.step"):
                    d = _consume(staged, done, dev)
                    state, outs, rows = _run_planned(bstep, state, plan, d,
                                                     rng)
                z = outs.z if collect_info else outs[0]
                sink.submit(plan.sink_keys, z, plan.valid, rows, seq=seq)
            part_outs.append((outs, d["valid"]))
            if plan.last:
                outs_all.append(_merge_subgroup_outs(part_outs,
                                                     collect_info))
                part_outs = []
    finally:
        stop.set()
        if th.is_alive():
            # abnormal exit with the prep thread possibly parked on a
            # staged read whose epoch's flush will never be submitted:
            # advance every partition past all staged epochs so the
            # ticket resolves and the thread can observe ``stop``
            try:
                for sq in sink._store_qs:
                    sq.put(("epoch", sink._staged_seq))
            except BaseException:   # pragma: no cover - best effort
                pass
        th.join()
    return state, outs_all


def _merge_subgroup_outs(parts, collect_info):
    """Merge a split group's sub-group outputs back into one per-group
    output.  Every real event lane is valid in exactly one sub-group (the
    split partitions the valid mask), so each sub-group is authoritative
    for its own lanes and per-block write counts sum.  Runs on the device
    (no host read); the unsplit common case passes the output through.
    """
    if len(parts) == 1:
        return parts[0][0]
    if not collect_info:
        z, w = parts[0][0]
        for (z2, w2), vmask in parts[1:]:
            z = torch.where(vmask, z2, z)
            w = w + w2
        return (z, w)
    o = parts[0][0]
    for o2, vmask in parts[1:]:
        m1, m2 = vmask, vmask[..., None]
        o = StepInfo(z=torch.where(m1, o2.z, o.z),
                     p=torch.where(m1, o2.p, o.p),
                     lam_hat=torch.where(m1, o2.lam_hat, o.lam_hat),
                     features=torch.where(m2, o2.features, o.features),
                     writes=o.writes + o2.writes)
    return o


def _concat_groups(outs_all, collect_info: bool, n_taus: int, dev):
    """Concatenate per-group outputs along the block axis: a StepInfo
    ``[n_blocks, B]``, or the per-block write counts."""
    with tracing.span("stream.concat"):
        if collect_info:
            if not outs_all:
                e = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt,
                                                              device=dev)
                return StepInfo(z=e(0, 0, dt=torch.bool), p=e(0, 0),
                                lam_hat=e(0, 0),
                                features=e(0, 0, 4 * n_taus),
                                writes=e(0, dt=torch.int32))
            return StepInfo(*(torch.cat(f) for f in zip(*outs_all)))
        if not outs_all:
            return torch.zeros((0,), dtype=torch.int32, device=dev)
        return torch.cat([o[1] for o in outs_all])
