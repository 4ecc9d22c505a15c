"""Open-loop serving tier: admission queue, dynamic batching, prefetch.

The counterpart of ``repro.serving.frontend``.  Everything before this
module runs *closed-loop*: the engine drivers pull pre-partitioned blocks
as fast as the device finishes them, so they cannot answer the question a
low-latency feature engine is bought for — what latency does a *request*
see under offered load?  ``ServingFrontend`` is that tier: per-event score
requests enter an admission queue, the queue is drained into engine
dispatches by a dynamic batcher, and the responses carry the same
bit-exact decisions, features and scores the closed-loop engine would have
produced for the identical event sequence.

Batching policy (the classic lateness/completeness trade, cf. Aion):

* a **full batch** (``batch`` queued requests) dispatches immediately;
* a **partial batch** dispatches when its *deadline* expires — the oldest
  queued request's arrival plus ``max_wait_s`` — so no request waits more
  than ``max_wait_s`` for co-riders;
* requests dispatch strictly in arrival (FIFO) order, so per-key event
  order is preserved and no request is dropped, duplicated or reordered.

Bit-exactness vs the closed-loop engine is a semantics statement and it is
mode-dependent, as the paper's §5 decoupling predicts:

* **exact mode** enforces per-key sequential semantics inside each block,
  so outputs are invariant to where the batcher cuts the stream: the
  frontend equals ``run_stream`` bit for bit under *any* arrival pattern,
  deadlines, partial batches and all.
* **fast mode** lets every event in a micro-batch read start-of-batch
  state, so block boundaries are semantic.  What holds is that a *padded*
  partial batch is bit-identical to an unpadded block of the same events
  (padding lanes are invalid and the fold keeps them out): the frontend
  equals a closed-loop run over its own dispatch boundaries, and equals
  ``run_stream`` outright whenever the boundaries coincide (e.g. full
  batches).

Padding lanes carry key 0, ``t = 0`` and ``valid = False``.  In exact mode
they sort behind every real lane and are never active in a write-back
launch, so a real event of key 0 in the same batch is the only writer of
row 0.

The scorer's products are only *shape*-stable (cuBLAS may pick another
algorithm for another width), so the frontend always scores the full
``[batch, F]`` feature block (``score_at_width``): partial batches run the
same products as full ones, and their scores equal the closed-loop
features scored through the same helper.

Prefetched hydration (the timely-prefetching design of Zapridou &
Ailamaki): with a bounded resident set (``residency=``), queued keys that
miss the slot table are read from the write-behind sink's stores *ahead of
their dispatch* — at admission, and again right after each dispatch's
flush is submitted (so the read rides the sink FIFO behind that flush and
observes the latest durable row).  A prefetched row is dropped (never
reused) whenever its key is part of a dispatched batch — the only way a
durable row can change — which keeps a mid-wait evict→rehydrate bit-exact.

Determinism seam: all waiting goes through a ``Clock`` (``now``/
``sleep``).  ``RealClock`` serves; ``VirtualClock`` advances time only
inside ``sleep``, so every batching/ordering/hydration invariant is
assertable in tests with no wall-clock sleeps.

Device: the frontend runs on its state's device.  Each dispatch's host
arrays are staged through ``core.stream._Stager`` (pinned buffers copied
on a second CUDA stream, the compute stream waiting on the copies' event;
plain tensors on the CPU), the step launches without waiting for the
device, and a batch's completion time is read after its outputs have been
copied to the host (``.cpu()``), so latency includes the device work.

Threaded admission plane (``admission="threaded"``): the admission thread
(the ``run`` caller) keeps the batching brain — clock loop, batch
composition, slot assignment, hydration reads on the sink's epoch-gated
staged lane, hydration packing and staging — and parks each staged batch
on a ready queue; a dispatch thread pops, makes its stream wait for the
batch's copies, launches the step, submits the flush (trailed by its
epoch marker) and materializes the outputs, so host packing of batch b+1
overlaps device compute of batch b.  Batch composition reads only arrivals
and the clock, so it is identical to serial admission under a
``VirtualClock``, and outputs are identical because batches dispatch in
composition order (one FIFO queue, one dispatch thread).  Read ordering
comes from the sink's ``stage_epoch`` lane: a read of key k waits exactly
for the flushes of k staged before it.

Adaptive partial-batch deadline (``adaptive_wait=True``, off by default):
an EWMA of request inter-arrival gaps estimates the time for the current
partial batch to fill; when that estimate beats ``max_wait_s`` the
deadline tightens to it.  The EWMA is a pure function of the arrival
schedule, so the tightened deadlines are deterministic under
``VirtualClock`` and identical across admission planes.
"""
from __future__ import annotations

import dataclasses
import math
import queue as queue_mod
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional, Protocol, Sequence

import numpy as np
import torch

from repro_torch.core.stream import (_block_runner, _consume,
                                     _residency_step, _sink_step, _Stager,
                                     hydration_width, pack_hydration)
from repro_torch.core.thinning import prng_key
from repro_torch.core.types import EngineConfig, Event
from repro_torch.streaming.residency import ResidencyMap

__all__ = ["ADMISSION", "Clock", "RealClock", "VirtualClock", "Request",
           "BatchRecord", "FrontendStats", "ServeResult", "ServingFrontend",
           "make_requests", "poisson_arrivals", "score_at_width"]

# admission planes: "serial" = single-thread admit+dispatch loop;
# "threaded" = admission/batching thread decoupled from the dispatch
# thread (host packing of the next batch overlaps device compute)
ADMISSION = ("serial", "threaded")


class Clock(Protocol):
    """Injectable time source: the frontend never touches wall time
    directly, so tests can drive the admission loop deterministically."""

    def now(self) -> float: ...

    def sleep(self, dt: float) -> None: ...


class RealClock:
    """Monotonic wall clock (serving / benchmarking).

    Time 0 is the clock's first reading — in the frontend, the start of
    ``run`` — so a clock built before a long request list is ready does
    not count that set-up as time the first requests spent waiting."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None

    def now(self) -> float:
        t = time.monotonic()
        if self._t0 is None:
            self._t0 = t
        return t - self._t0

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"RealClock(t={self.now():.6f})"


class VirtualClock:
    """Deterministic clock: time advances only inside ``sleep``.

    Compute and storage take zero virtual time, so dispatch instants are
    exact functions of the arrival schedule and ``max_wait_s`` — the seam
    every batching/deadline test stands on (no wall-clock sleeps).
    """

    def __init__(self, t0: float = 0.0) -> None:
        self._t = float(t0)
        self.sleeps = 0

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float) -> None:
        if dt > 0:
            self._t += dt
            self.sleeps += 1

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"VirtualClock(t={self._t:.6f}, sleeps={self.sleeps})"


class Request(NamedTuple):
    """One score request: an event plus its admission-clock arrival."""
    rid: int            # position in the caller's request list
    key: int            # global entity id
    q: float            # event mark
    t: float            # event timestamp (engine time, not clock time)
    arrival_s: float    # admission-clock arrival


class BatchRecord(NamedTuple):
    """One dispatch, as the admission loop saw it."""
    t_dispatch: float   # clock time the batch left the queue
    t_complete: float   # clock time its outputs were on the host
    size: int           # valid lanes (<= batch)
    full: bool          # True: dispatched because the batch filled
    deadline: float     # the deadline that applied (inf for full batches)
    n_miss: int         # resident-set misses hydrated for this batch
    n_prefetched: int   # misses served by an already-in-flight read


@dataclasses.dataclass
class FrontendStats:
    """Admission/batching/prefetch accounting for one ``run``."""
    dispatches: int = 0
    full_batches: int = 0
    deadline_batches: int = 0
    # deadline batches whose deadline the adaptive wait tightened below
    # ``max_wait_s`` (0 unless ``adaptive_wait=True``)
    adaptive_tightened: int = 0
    events: int = 0
    padded_lanes: int = 0
    max_queue: int = 0
    # hydration prefetch (residency mode only)
    prefetch_issued: int = 0        # keys with a read submitted early
    prefetch_hits: int = 0          # misses served from an in-flight read
    prefetch_rehydrations: int = 0  # prefetches of a previously-seen key
    demand_reads: int = 0           # misses that had to read at dispatch
    # prefetched keys already resident in the sink's host L2 tier at
    # submit time — those reads resolve from host RAM, no durable get
    # (advisory: sampled on the admission thread against a cache the
    # flush workers mutate; the read itself probes authoritatively)
    prefetch_l2_hits: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServeResult:
    """Per-request outputs in the caller's request order (index = rid)."""
    z: np.ndarray             # [N] persistence decisions
    p: np.ndarray             # [N] inclusion probabilities
    lam_hat: np.ndarray       # [N] intensity estimates
    features: np.ndarray      # [N, F] profile feature vectors
    scores: Optional[np.ndarray]   # [N] anomaly logits (None: no scorer)
    latency_s: np.ndarray     # [N] completion - arrival on the clock
    order: np.ndarray         # [N] rids in dispatch order (FIFO audit)
    batches: List[BatchRecord]
    stats: FrontendStats

    def latency_quantiles(self, qs=(0.5, 0.99, 0.999)) -> dict:
        lat = np.asarray(self.latency_s, np.float64)
        name = lambda q: "p" + format(q * 100, "g").replace(".", "")
        if lat.size == 0:
            return {name(q): float("nan") for q in qs}
        return {name(q): float(np.quantile(lat, q)) for q in qs}


def make_requests(keys, qs, ts, arrival_s=None) -> List[Request]:
    """Wrap flat event arrays as requests.

    ``arrival_s`` defaults to ``ts`` rebased to start at 0 — open-loop
    arrivals at the event timestamps.  Requests are sorted by arrival
    (stable, so same-instant requests keep stream order and per-key order
    is preserved).
    """
    keys = np.asarray(keys).reshape(-1)
    qs = np.asarray(qs, np.float32).reshape(-1)
    ts = np.asarray(ts, np.float32).reshape(-1)
    if arrival_s is None:
        arrival_s = ts - (ts[0] if ts.size else 0.0)
    arrival_s = np.asarray(arrival_s, np.float64).reshape(-1)
    if not (keys.size == qs.size == ts.size == arrival_s.size):
        raise ValueError("keys/qs/ts/arrival_s length mismatch")
    order = np.argsort(arrival_s, kind="stable")
    return [Request(int(i), int(keys[i]), float(qs[i]), float(ts[i]),
                    float(arrival_s[i])) for i in order]


def poisson_arrivals(n: int, rate: float, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """Open-loop Poisson arrival times: ``n`` events at ``rate`` per sec."""
    if rate <= 0.0:
        raise ValueError("rate must be positive")
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1.0 / rate, n))


def score_at_width(scorer, features, width: int) -> np.ndarray:
    """Score ``k <= width`` feature rows at the fixed padded width.

    ``features``: [k, F], a host array or a tensor.  The rows are moved to
    the scorer's device, padded with zero rows to ``[width, F]``, scored
    through ``serving.pipeline.score`` and trimmed: the products run at
    one shape whatever ``k`` is, so a row's score does not depend on how
    many rows shared its batch.  The closed-loop comparisons score
    reference features through this same helper.
    """
    from repro_torch.serving.pipeline import score

    feats = torch.as_tensor(features, dtype=torch.float32,
                            device=scorer.w1.device)
    k = feats.shape[0]
    if k > width:
        raise ValueError(f"{k} rows exceed scoring width {width}")
    if k < width:
        feats = torch.cat([feats, feats.new_zeros(
            (width - k,) + tuple(feats.shape[1:]))])
    return score(scorer, feats)[:k].cpu().numpy()


class ServingFrontend:
    """Admission queue + dynamic batcher over the engine's step drivers.

    ``cfg``/``mode``/``exact_impl`` select the same per-group drivers the
    closed-loop ``run_stream`` uses (``core.stream``): the plain block
    loop (no sink), the sink step (write-behind persistence), or the
    residency step (bounded slot state + hydration scatter) — each driven
    one ``[1, batch]`` block at a time, padded with invalid lanes.

    The frontend owns ``state`` and updates it **in place** on its device
    (the JAX frontend's donated state is "dead to the caller"; here the
    caller's tensors are the frontend's and change with every dispatch):
    copy the state first if the pre-serving state is needed.  A ``sink``
    must be built for the state's device.

    ``residency`` must be a prebuilt ``streaming.residency.ResidencyMap``
    whose slot count equals ``state.num_entities`` and is >= ``batch`` (a
    batch's distinct keys must fit the resident set); it requires ``sink``
    — the stores are the backing level misses hydrate from.  Thinning
    stays keyed on global entity ids, so decisions are residency-invariant
    like the closed-loop driver's.

    Thread model: with ``admission="serial"`` (default), a single driver
    thread (the caller of ``run``); the only concurrency is the sink's own
    flush/read workers, reached through the same ordered ``submit``/
    ``submit_read`` calls as the closed-loop residency driver.  With
    ``admission="threaded"``, the caller's thread becomes the admission
    plane and a dispatch thread (with the state's CUDA device set) owns the
    launches, the flush submit and the copies to the host — a two-deep
    ping-pong bounded by a staging-token pair and two staging generations,
    the pipelined residency driver's shape.  Residency under threaded
    admission requires a threaded sink with ``overflow="block"`` (a serial
    sink cannot run the epoch lane; a degraded sink flushes inline on the
    dispatch thread, racing the admission thread's reads).

    ``adaptive_wait=True`` enables the adaptive partial-batch deadline
    (see module docstring); ``stats.adaptive_tightened`` counts the
    deadline batches that dispatched earlier because of it.
    """

    def __init__(self, cfg: EngineConfig, state, *, batch: int,
                 max_wait_s: float, mode: str = "fast",
                 exact_impl: str = "compact", rng=None,
                 clock: Optional[Clock] = None, sink=None,
                 residency: Optional[ResidencyMap] = None, scorer=None,
                 admission: str = "serial", adaptive_wait: bool = False,
                 adaptive_alpha: float = 0.2):
        if batch <= 0:
            raise ValueError("batch must be positive")
        if max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        if admission not in ADMISSION:
            raise ValueError(f"admission must be one of {ADMISSION}")
        if not (0.0 < adaptive_alpha <= 1.0):
            raise ValueError("adaptive_alpha must be in (0, 1]")
        self.cfg = cfg
        self.batch = int(batch)
        self.max_wait_s = float(max_wait_s)
        self.mode = mode
        self.clock: Clock = clock if clock is not None else RealClock()
        self.sink = sink
        self.scorer = scorer
        self.state = state
        self.device = state.device
        self.rng = prng_key(0) if rng is None else rng
        self.stats = FrontendStats()
        self._rmap = residency
        self._n_taus = int(state.num_taus)
        self.admission = admission
        self._threaded = admission == "threaded"
        self.adaptive_wait = bool(adaptive_wait)
        self._alpha = float(adaptive_alpha)
        self._ewma_ia: Optional[float] = None   # EWMA inter-arrival gap
        self._last_arrival: Optional[float] = None
        self._disp_exc: Optional[BaseException] = None
        # key -> (ReadTicket, index into the ticket's key list)
        self._prefetch: dict = {}
        # residency: queued requests per key, so a dispatch can find which
        # of its victims are still queued without scanning the queue
        self._queued = (np.zeros(residency.num_keys, np.int64)
                        if isinstance(residency, ResidencyMap) else None)
        if sink is not None and sink.device != self.device:
            raise ValueError(f"the sink is for {sink.device} but the state "
                             f"lives on {self.device}")
        if self._threaded and residency is not None:
            if getattr(sink, "_serial", False):
                raise ValueError(
                    "admission='threaded' with residency requires a "
                    "threaded sink (queue_depth >= 1): the admission "
                    "thread's staged reads need the epoch lane's store "
                    "workers")
            if getattr(sink, "_overflow", "block") != "block":
                raise ValueError(
                    "admission='threaded' requires overflow='block': a "
                    "degraded sink flushes inline on the dispatch "
                    "thread, racing the admission thread's reads")
        if residency is not None:
            if sink is None:
                raise ValueError("residency requires a write-behind sink: "
                                 "misses hydrate from its durable stores")
            if not isinstance(residency, ResidencyMap):
                raise ValueError("residency must be a prebuilt ResidencyMap")
            if state.num_entities != residency.n_slots:
                raise ValueError(
                    f"state holds {state.num_entities} rows but the "
                    f"resident set has {residency.n_slots} slots")
            if residency.n_slots < self.batch:
                raise ValueError(
                    f"batch={self.batch} can hold more distinct keys than "
                    f"the {residency.n_slots}-slot resident set")
            self._bstep = _residency_step(cfg, mode, True, exact_impl)
            # fixed hydration width: one staging shape for every dispatch
            # (the closed-loop driver lets it track the per-group miss
            # count); the step scatters only the real lanes
            self._hwidth = hydration_width(self.batch)
        elif sink is not None:
            self._bstep = _sink_step(cfg, mode, True, exact_impl)
        else:
            self._bstep = _block_runner(cfg, mode, True, exact_impl)

    # ------------------------------------------------------------- serve
    def run(self, requests: Sequence[Request]) -> ServeResult:
        """Drive the open-loop admission queue over a request schedule.

        ``requests`` must be arrival-sorted (``make_requests`` does this);
        the loop admits each request at its ``arrival_s`` on the clock,
        dispatches full batches immediately and partial batches at their
        deadline, and returns per-request outputs aligned with rids.
        """
        reqs = list(requests)
        n = len(reqs)
        for a, b in zip(reqs, reqs[1:]):
            if b.arrival_s < a.arrival_s:
                raise ValueError("requests must be sorted by arrival_s")
        F = 4 * len(self.cfg.taus)
        out = ServeResult(
            z=np.zeros(n, bool), p=np.zeros(n, np.float32),
            lam_hat=np.zeros(n, np.float32),
            features=np.zeros((n, F), np.float32),
            scores=np.zeros(n, np.float32) if self.scorer is not None
            else None,
            latency_s=np.zeros(n, np.float64),
            order=np.zeros(n, np.int64), batches=[], stats=self.stats)
        if n == 0:
            return out
        self._ewma_ia = None
        self._last_arrival = None
        self._disp_exc = None
        if self._rmap is not None:
            self._queued[:] = 0
            # drain in-flight work a previous run left behind: the
            # unordered fresh-read lane is only safe against writes
            # submitted after this point (same rule as the closed-loop
            # residency driver)
            self.sink.flush()
        if self._threaded:
            return self._run_threaded(reqs, out)
        stager = _Stager(self.device, 1)
        self._admission_loop(
            reqs, out, lambda pending, out_, done, **kw: self._dispatch(
                pending, out_, done, stager, **kw))
        return out

    # --------------------------------------------------------- internals
    def _admission_loop(self, reqs, out: ServeResult, dispatch) -> None:
        """The batching brain, shared by both admission planes.

        ``dispatch`` composes, stages and launches a batch inline (serial)
        or composes and stages it for the dispatch thread (threaded).
        Every decision here — admits, batch cuts, deadlines — reads only
        the arrival schedule and the clock, which is what makes threaded
        composition identical to serial under a ``VirtualClock``.
        """
        n = len(reqs)
        pending: deque = deque()
        i = 0
        done = 0
        while (i < n or pending) and self._disp_exc is None:
            now = self.clock.now()
            first = i
            while i < n and reqs[i].arrival_s <= now:
                r = reqs[i]
                if self._last_arrival is not None:
                    gap = r.arrival_s - self._last_arrival
                    self._ewma_ia = (gap if self._ewma_ia is None else
                                     self._alpha * gap +
                                     (1.0 - self._alpha) * self._ewma_ia)
                self._last_arrival = r.arrival_s
                pending.append(r)
                i += 1
            if self._rmap is not None and i > first:
                # one prefetch read for everything this sweep admitted
                # (a burst admits many requests at once)
                admitted = [r.key for r in reqs[first:i]]
                np.add.at(self._queued, admitted, 1)
                self._prefetch_keys(admitted)
            self.stats.max_queue = max(self.stats.max_queue, len(pending))
            if len(pending) >= self.batch:
                done = dispatch(pending, out, done, full=True,
                                deadline=math.inf)
                continue
            wait = (self._effective_wait(len(pending)) if pending
                    else self.max_wait_s)
            deadline = (pending[0].arrival_s + wait
                        if pending else math.inf)
            if now >= deadline:
                done = dispatch(pending, out, done, full=False,
                                deadline=deadline,
                                tightened=wait < self.max_wait_s)
                continue
            next_arrival = reqs[i].arrival_s if i < n else math.inf
            # ties admit first: a request landing exactly on the deadline
            # still rides the dispatching batch
            self.clock.sleep(min(deadline, next_arrival) - now)

    def _effective_wait(self, k: int) -> float:
        """Partial-batch wait cap for a queue of ``k`` requests.

        Adaptive deadline (off unless ``adaptive_wait=True``): the EWMA
        of inter-arrival gaps estimates the fill time for the remaining
        ``batch - k`` lanes; if the batch was going to fill, it fills by
        about then, so waiting past the estimate buys no co-riders —
        only tail latency.  The EWMA is built purely from admitted
        requests' ``arrival_s`` gaps, never from the clock, so the
        tightened deadlines are deterministic under ``VirtualClock`` and
        identical across admission planes.
        """
        if not self.adaptive_wait or self._ewma_ia is None:
            return self.max_wait_s
        est_fill = (self.batch - k) * self._ewma_ia
        return min(self.max_wait_s, est_fill)

    def _compose(self, pending: deque, *, full: bool, tightened: bool):
        """Pop one batch off the queue and pad it to ``batch`` lanes (key
        0, t = 0, invalid)."""
        k = min(self.batch, len(pending))
        batch_reqs = [pending.popleft() for _ in range(k)]
        B = self.batch
        keys = np.zeros(B, np.int64)
        qs = np.zeros(B, np.float32)
        ts = np.zeros(B, np.float32)
        valid = np.zeros(B, bool)
        keys[:k] = [r.key for r in batch_reqs]
        qs[:k] = [r.q for r in batch_reqs]
        ts[:k] = [r.t for r in batch_reqs]
        valid[:k] = True
        if self._rmap is not None:
            np.subtract.at(self._queued, keys[:k], 1)
        t_disp = self.clock.now()
        st = self.stats
        st.dispatches += 1
        st.events += k
        st.padded_lanes += B - k
        if full:
            st.full_batches += 1
        else:
            st.deadline_batches += 1
            if tightened:
                st.adaptive_tightened += 1
        arrays = dict(key=keys, q=qs, t=ts, valid=valid)
        return batch_reqs, k, arrays, t_disp

    def _plan_hydration(self, arrays: dict, staged: bool):
        """Residency half of a batch, on the admission thread: assign
        slots, resolve the misses' rows (prefetched or read now), then —
        for the threaded plane — stage the batch's flush epoch (after its
        own reads: a batch must not wait on its own epoch) and prefetch
        the still-queued victims, and pack the hydration lanes into
        ``arrays``.  Returns ``(n_miss, n_prefetched, epoch or None,
        evicted keys)``."""
        keys, valid = arrays["key"], arrays["valid"]
        asn = self._rmap.assign_group(keys, valid)
        # victims leave the slot plane -> the sink's host L2 tier (if
        # any): a later prefetch/demand read of them resolves from host
        # RAM instead of a durable get
        self.sink.demote(asn.evicted)
        n_miss = int(asn.miss_keys.size)
        rows, n_pre = self._hydration_rows(asn, keys[valid])
        seq = None
        if staged:
            seq = self.sink.stage_epoch(keys, valid)
            # later queued keys' staged reads now gate on this batch's
            # flush, as the serial plane's ride-the-FIFO prefetch does
            self._prefetch_victims(asn.evicted)
        h_slots, h_scal, h_agg = pack_hydration(
            rows, asn.miss_slots, self.sink.serde, self._rmap.n_slots,
            self._n_taus, width=self._hwidth)
        arrays.update(slot=asn.slot.astype(np.int64),
                      h_slots=h_slots.astype(np.int64), h_scal=h_scal,
                      h_agg=h_agg)
        return n_miss, n_pre, seq, asn.evicted

    def _launch(self, d: dict, n_miss: int, keys, valid, seq=None):
        """Run one staged ``[1, batch]`` block on the device and hand its
        rows to the sink; returns the block's StepInfo (on the device)."""
        row = lambda x: x.view(1, self.batch)
        q, t, v = row(d["q"]), row(d["t"]), row(d["valid"])
        if self._rmap is not None:
            ev = Event(key=row(d["slot"]), q=q, t=t, valid=v)
            self.state, outs, rows = self._bstep(
                self.state, (ev, row(d["key"])), self.rng, d["slot"],
                d["h_slots"], d["h_scal"], d["h_agg"], n_miss)
            self.sink.submit(keys, outs.z, valid, rows, seq=seq)
        elif self.sink is not None:
            ev = Event(key=row(d["key"]), q=q, t=t, valid=v)
            self.state, outs, rows = self._bstep(self.state, ev, self.rng,
                                                 d["key"])
            self.sink.submit(keys, outs.z, valid, rows)
        else:
            ev = Event(key=row(d["key"]), q=q, t=t, valid=v)
            self.state, outs = self._bstep(self.state, ev, self.rng)
        return outs

    def _dispatch(self, pending: deque, out: ServeResult, done: int,
                  stager: _Stager, *, full: bool, deadline: float,
                  tightened: bool = False) -> int:
        batch_reqs, k, arrays, t_disp = self._compose(
            pending, full=full, tightened=tightened)
        n_miss = n_pre = 0
        if self._rmap is not None:
            n_miss, n_pre, _, evicted = self._plan_hydration(arrays, False)
        keys, valid = arrays["key"], arrays["valid"]
        d = _consume(*stager.stage(arrays), self.device)
        outs = self._launch(d, n_miss, keys, valid)
        # prefetch the *next* batches' misses now, while this batch's
        # device compute and flush are still in flight: the ordered read
        # rides the sink FIFO behind the flush just submitted, so a key
        # this batch evicted reads its latest durable row
        if self._rmap is not None:
            self._prefetch_victims(evicted)
        self._materialize(out, batch_reqs, k, full, deadline, t_disp, outs,
                          done, n_miss, n_pre)
        return done + k

    # ------------------------------------------- threaded admission plane
    def _run_threaded(self, reqs, out: ServeResult) -> ServeResult:
        """Admission/batching on the caller's thread, device dispatch on
        a worker: the serving twin of ``_drive_pipelined_residency``."""
        ready: queue_mod.Queue = queue_mod.Queue()
        # ping-pong staging pair: at most two batches staged-but-not-yet-
        # popped, released when the dispatch thread pops, so batch b+1
        # packs during batch b's compute; the two staging generations'
        # copy events guard the pinned buffers themselves
        tokens = threading.BoundedSemaphore(2)
        stager = _Stager(self.device, 2)
        dev = self.device

        def dispatch_loop() -> None:
            try:
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                while True:
                    item = ready.get()
                    if item is None:
                        return
                    tokens.release()
                    self._finish(out, *item)
            except BaseException as e:  # noqa: BLE001 - re-raised in run
                self._disp_exc = e
                sink = self.sink
                if sink is not None and getattr(sink, "_store_qs", None):
                    # epochs staged for batches that will now never flush
                    # would park the admission thread's reads forever —
                    # push the high-water marker to every store to unpark
                    # them (same abnormal-exit rule as the core driver)
                    for sq in sink._store_qs:
                        sq.put(("epoch", sink._staged_seq))

        th = threading.Thread(target=dispatch_loop,
                              name="frontend-dispatch", daemon=True)
        th.start()

        def stage(pending, out_, done, *, full, deadline, tightened=False):
            return self._stage(pending, out_, done, ready, tokens, stager,
                               full=full, deadline=deadline,
                               tightened=tightened)

        try:
            self._admission_loop(reqs, out, stage)
        finally:
            ready.put(None)
            th.join()
        if self._disp_exc is not None:
            raise RuntimeError("frontend dispatch thread failed") \
                from self._disp_exc
        return out

    def _stage(self, pending: deque, out: ServeResult, done: int,
               ready: "queue_mod.Queue", tokens, stager: _Stager, *,
               full: bool, deadline: float, tightened: bool = False) -> int:
        while not tokens.acquire(timeout=0.1):
            if self._disp_exc is not None:
                raise RuntimeError("frontend dispatch thread failed") \
                    from self._disp_exc
        batch_reqs, k, arrays, t_disp = self._compose(
            pending, full=full, tightened=tightened)
        n_miss = n_pre = 0
        seq = None
        if self._rmap is not None:
            # demand reads ride the staged/unordered lanes and are waited
            # here, on the admission thread
            n_miss, n_pre, seq, _ = self._plan_hydration(arrays, True)
        keys, valid = arrays["key"], arrays["valid"]
        staged, copied = stager.stage(arrays)
        ready.put((done, batch_reqs, k, full, deadline, t_disp,
                   (staged, copied, keys, valid, seq, n_miss, n_pre)))
        return done + k

    def _finish(self, out: ServeResult, done: int, batch_reqs, k: int,
                full: bool, deadline: float, t_disp: float,
                payload) -> None:
        """Dispatch-thread half of a staged batch: wait for its copies,
        launch, submit the flush (trailed by the staged epoch), copy the
        outputs to the host."""
        staged, copied, keys, valid, seq, n_miss, n_pre = payload
        d = _consume(staged, copied, self.device)
        outs = self._launch(d, n_miss, keys, valid, seq)
        self._materialize(out, batch_reqs, k, full, deadline, t_disp, outs,
                          done, n_miss, n_pre)

    def _materialize(self, out: ServeResult, batch_reqs, k: int,
                     full: bool, deadline: float, t_disp: float, outs,
                     done: int, n_miss: int, n_pre: int) -> None:
        scores = (score_at_width(self.scorer, outs.features[0], self.batch)
                  if self.scorer is not None else None)
        # the copies wait for the device: completion includes its work
        feats = outs.features[0].cpu().numpy()
        z = outs.z[0].cpu().numpy()
        p = outs.p[0].cpu().numpy()
        lam = outs.lam_hat[0].cpu().numpy()
        t_done = self.clock.now()
        rids = np.fromiter((r.rid for r in batch_reqs), np.int64, k)
        arrival = np.fromiter((r.arrival_s for r in batch_reqs), np.float64,
                              k)
        out.z[rids] = z[:k]
        out.p[rids] = p[:k]
        out.lam_hat[rids] = lam[:k]
        out.features[rids] = feats[:k]
        if scores is not None:
            out.scores[rids] = scores[:k]
        out.latency_s[rids] = t_done - arrival
        out.order[done:done + k] = rids
        out.batches.append(BatchRecord(t_disp, t_done, k, full, deadline,
                                       n_miss, n_pre))

    def _hydration_rows(self, asn, batch_keys):
        """Resolve this batch's miss rows: in-flight prefetch tickets
        first, demand reads (fresh keys on the unordered fast lane,
        rehydrations on the FIFO) for the rest.  Every key of the batch —
        hit or miss — drops its prefetch entry: the flush about to be
        submitted may change its durable row, so a held ticket would go
        stale."""
        st = self.stats
        miss = [int(k) for k in asn.miss_keys]
        picked = [self._prefetch.pop(k, None) for k in miss]
        need = [j for j, t in enumerate(picked) if t is None]
        need_fresh = [j for j in need if asn.miss_fresh[j]]
        need_re = [j for j in need if not asn.miss_fresh[j]]
        t_fresh = t_re = None
        if need_fresh:
            t_fresh = self.sink.submit_read(
                np.asarray([miss[j] for j in need_fresh], np.int64),
                ordered=False)
        if need_re:
            # serial admission: the FIFO lane sequences the read behind
            # every already-submitted flush; threaded admission: the
            # admission thread races the dispatch thread's submits, so
            # the read gates on the key's staged epochs instead
            t_re = self.sink.submit_read(
                np.asarray([miss[j] for j in need_re], np.int64),
                staged=self._threaded)
        st.demand_reads += len(need)
        st.prefetch_hits += len(miss) - len(need)
        rows: List[Optional[bytes]] = [None] * len(miss)
        for j, ent in enumerate(picked):
            if ent is not None:
                ticket, idx = ent
                rows[j] = ticket.result()[idx]
        if t_fresh is not None:
            got = t_fresh.result()
            for pos, j in enumerate(need_fresh):
                rows[j] = got[pos]
        if t_re is not None:
            got = t_re.result()
            for pos, j in enumerate(need_re):
                rows[j] = got[pos]
        # invalidate held tickets for *every* key of the batch (hits too):
        # their rows are about to be rewritten by this batch's flush
        for k in np.unique(batch_keys):
            self._prefetch.pop(int(k), None)
        return rows, len(miss) - len(need)

    def _prefetch_victims(self, evicted) -> None:
        """Prefetch the keys a dispatch evicted that are still queued.

        Every queued key is resident or has a read in flight (admission
        prefetches it, and a dispatch only makes its own keys resident);
        a dispatch breaks that only for its victims.  So this reads
        exactly what prefetching the whole queue would, without scanning
        it."""
        evicted = np.asarray(evicted, np.int64)
        if evicted.size:
            self._prefetch_keys(evicted[self._queued[evicted] > 0])

    def _prefetch_keys(self, keys) -> None:
        """Submit ordered hydration reads for queued keys that are not
        resident and have no read in flight (no-op without residency)."""
        if self._rmap is None:
            return
        ks = np.unique(np.asarray(keys, np.int64))
        ks = ks[self._rmap.slot_of_key[ks] < 0]
        want = [k for k in ks.tolist() if k not in self._prefetch]
        if not want:
            return
        seen = self._rmap.seen(want)
        ticket = self.sink.submit_read(np.asarray(want, np.int64),
                                       staged=self._threaded)
        for idx, k in enumerate(want):
            self._prefetch[k] = (ticket, idx)
        self.stats.prefetch_issued += len(want)
        self.stats.prefetch_rehydrations += int(np.count_nonzero(seen))
        self.stats.prefetch_l2_hits += int(np.count_nonzero(
            self.sink.l2_contains(want)))
