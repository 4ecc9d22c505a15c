"""Block driver for the vectorized engine (PyTorch).

The counterpart of ``repro.core.stream`` for the dense path and the serial
write-behind sink path.  The JAX driver scans ``[n_batches, B]`` event
blocks through one jitted program with the state as a donated carry; here a
Python loop feeds the blocks to the engine step, which updates the state
**in place**.  So the state passed to ``run_stream`` is the state it
returns, mutated: a caller that needs the pre-stream state copies it first.
There is no jit and no donation; of the JAX driver's aliasing contract only
"every leaf owns its storage" remains, which ``init_state`` guarantees.

The loop never waits for the device: each block's outputs stay on the
device until the caller (or the sink's flush thread) reads them.  With a
sink, the rows handed over after each flush group are gathered *copies*
of the state, so the flush thread's device-to-host conversion reads the
group's end-of-group rows while the next group updates the state.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from repro_torch.core.engine import make_step
from repro_torch.core.thinning import prng_key
from repro_torch.core.types import EngineConfig, Event, ProfileState, StepInfo

__all__ = ["run_stream", "block_runner_for", "sink_step_for"]


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
            outs.append(info if collect_info else (info.z, info.writes))
        outs = (_stack(outs, True) if collect_info else
                (torch.stack([o[0] for o in outs]),
                 torch.stack([o[1] for o in outs])))
        take = lambda x: torch.index_select(x, 0, gather_idx)
        scal = torch.stack([take(state.last_t), take(state.v_f),
                            take(state.v_full), take(state.last_t_full)])
        return state, outs, (scal, take(state.agg))

    return run


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

    Not ported yet (ROADMAP.md, queue 1 item 7): bounded residency
    (``residency=``) and the pipelined plane (``pipeline_depth > 1``).
    """
    if residency is not None:
        raise NotImplementedError(
            "run_stream(residency=...) is not ported to repro_torch yet "
            "(ROADMAP.md queue 1 item 7: residency, L2 tier, pipelining)")
    if int(pipeline_depth) < 1:
        raise ValueError("pipeline_depth must be >= 1")
    if int(pipeline_depth) > 1:
        raise NotImplementedError(
            "run_stream(pipeline_depth > 1) is not ported to repro_torch yet "
            "(ROADMAP.md queue 1 item 7: residency, L2 tier, pipelining)")
    if rng is None:
        rng = prng_key(0)
    dev = state.device
    n = int(np.shape(keys)[0])
    pad = (-n) % batch
    host_blocks = lambda x, fill: np.reshape(
        np.pad(np.asarray(x), (0, pad), constant_values=fill), (-1, batch))
    key_h = host_blocks(np.asarray(keys, np.int32), 0)
    q_h = host_blocks(np.asarray(qs, np.float32), 0.0)
    t_h = host_blocks(np.asarray(ts, np.float32), 0.0)
    valid_h = host_blocks(np.ones(n, bool), False)
    events = Event(*(torch.from_numpy(x).to(dev)
                     for x in (key_h.astype(np.int64), q_h, t_h, valid_h)))
    step = make_step(cfg, mode, exact_impl=exact_impl)

    if key_h.shape[0] == 0:
        info = _concat_groups([], collect_info, len(cfg.taus), dev)
    elif sink is not None:
        if sink.device != dev:
            raise ValueError(f"the sink is for {sink.device} but the state "
                             f"lives on {dev}")
        group = max(1, int(sink_group))
        run_group = sink_step_for(step, collect_info)
        outs_all = []
        for lo in range(0, key_h.shape[0], group):
            hi = min(lo + group, key_h.shape[0])
            ev = Event(*(x[lo:hi] for x in events))
            state, outs, rows = run_group(state, ev, rng,
                                          ev.key.reshape(-1))
            z = outs.z if collect_info else outs[0]
            sink.submit(key_h[lo:hi].reshape(-1), z,
                        valid_h[lo:hi].reshape(-1), rows)
            outs_all.append(outs if collect_info else outs[1])
        info = _concat_groups(outs_all, collect_info, len(cfg.taus), dev)
    else:
        state, info = block_runner_for(step, collect_info)(state, events,
                                                           rng)
    if not collect_info:
        return state, info
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))[:n]
    return state, StepInfo(
        z=flat(info.z), p=flat(info.p), lam_hat=flat(info.lam_hat),
        features=flat(info.features),
        writes=info.writes.sum().to(torch.int32))


def _concat_groups(outs_all, collect_info: bool, n_taus: int, dev):
    """Concatenate per-group outputs along the block axis."""
    if collect_info:
        if not outs_all:
            e = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt,
                                                          device=dev)
            return StepInfo(z=e(0, 0, dt=torch.bool), p=e(0, 0),
                            lam_hat=e(0, 0), features=e(0, 0, 4 * n_taus),
                            writes=e(0, dt=torch.int32))
        return StepInfo(*(torch.cat(f) for f in zip(*outs_all)))
    if not outs_all:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    return torch.cat(outs_all)
