"""Write-behind durable persistence for the vectorized fast path (PyTorch).

The counterpart of ``repro.streaming.persistence``, with the same byte
contract: for the same stream, policy, rng and partitions the bytes this
sink stores equal the bytes the JAX package's sink stores, and
``hydrate_state(stores)`` rebuilds the exact-mode engine state bit for bit.
The engine streams ahead on the device while background threads convert,
serialize and land the thinned rows of completed flush groups:

1. the block driver (``core.stream.run_stream(..., sink=...)``) updates
   the state in place and *gathers* each lane's post-update profile row
   into a fresh tensor (pure data movement, so stored bytes are the engine
   state's bytes);
2. ``submit`` hands ``(keys, z, valid, rows)`` to a bounded queue, so a
   slow store backpressures the driver;
3. the dispatcher thread converts device tensors to host arrays
   (``.cpu()`` — the only point that waits for the device), dedupes keys
   last-write-wins, packs them with the vectorized SerDe and fans each
   partition's slice out to that partition's store worker;
4. ``submit_read`` queues batched ``multi_get``s through the same FIFO
   pipeline, so a read observes every flush submitted before it — the
   ordering the bounded-residency drivers (``core.stream.run_stream(
   residency=...)``) rehydrate evicted keys through.  Two more lanes
   serve them: the unordered lane (``ordered=False``) for first-touch
   keys no flush can hold, and the epoch-gated lane (``stage_epoch`` +
   ``staged=True``) with which the pipelined drivers order a read behind
   a flush that is not submitted yet.

The full-stream control column (``v_full``/``last_t_full``) is persisted
only under the full-stream policies ('full'/'unfiltered'); thinning
policies store the fresh (0.0, -inf) column and recovery restarts the
control estimate cold.

"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.types import (EngineConfig, ProfileState,
                                    resolve_device, state_from_numpy)
from repro_torch.streaming.durable import BACKENDS, open_partition_stores
from repro_torch.streaming.kvstore import KVStore, SerDe, StorageModel
from repro_torch.streaming.residency import HostL2Cache

__all__ = ["WriteBehindSink", "SinkStats", "ReadTicket", "RetryPolicy",
           "hydrate_state", "FULL_STREAM_POLICIES"]

# Policies whose durable rows include the full-stream control column (they
# write back on every event, so the stored column stays current).
FULL_STREAM_POLICIES = ("full", "unfiltered")

_STOP = object()

OVERFLOW_POLICIES = ("block", "degrade-to-serial")


def _host(x) -> np.ndarray:
    """A host numpy array of ``x`` (``np.asarray`` raises on CUDA tensors)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for transient storage errors.

    Every store op a flush worker issues (``multi_put``/``multi_get``) runs
    under this policy: an exception matching ``retry_on`` is retried up to
    ``retries`` times, sleeping ``base_s * factor**attempt`` between
    attempts; exhaustion re-raises and poisons the sink like any other
    flush failure.  Safe because the durable backend's append is
    failure-atomic (``DurableStore._append_batch`` restores the WAL to its
    pre-batch length on error) and its seq guard makes replay idempotent —
    a retried batch can never be applied twice or leave a torn record
    mid-file.  ``streaming.faults.TransientIOError`` is an ``OSError``, so
    injected faults exercise exactly this path.
    """
    retries: int = 4
    base_s: float = 0.002
    factor: float = 2.0
    retry_on: Tuple[type, ...] = (OSError,)


@dataclasses.dataclass
class SinkStats:
    """Host-side sink accounting (store-side counters live on the stores)."""
    blocks: int = 0
    events_seen: int = 0        # valid lanes observed
    selected: int = 0           # lanes whose row is durable this block
    rows_stored: int = 0        # after intra-block last-write-wins dedupe
    dedup_saved: int = 0        # selected - rows_stored
    serde_s: float = 0.0        # vectorized pack time (dispatcher thread)
    flush_s: float = 0.0        # total dispatcher busy time
    submit_wait_s: float = 0.0  # backpressure: time submit() blocked
    # read path (hydration): submitted reads, rows requested, and the time
    # the driver spent blocked on ticket results
    reads: int = 0
    rows_read: int = 0
    read_wait_s: float = 0.0
    # fault handling: transient store errors seen, retries issued, time
    # slept in backoff, ops that exhausted the retry budget, and flushes
    # degraded to the driver thread by the overflow policy
    transient_errors: int = 0
    retries: int = 0
    retry_wait_s: float = 0.0
    flush_errors: int = 0
    degraded_flushes: int = 0
    # host-RAM L2 tier (``l2=`` knob): hydration-read rows answered from
    # packed host bytes instead of durable gets, and slot evictions
    # demoted into the cache (synced from the caches at ``snapshot``)
    l2_hits: int = 0
    l2_demotions: int = 0
    # host/device time split (synced from the sink's ``_OverlapMeter`` at
    # ``snapshot``): ``host_pack_s`` is driver-side group planning+packing
    # (the drivers wrap it in ``overlap.host()``), ``device_wait_s`` is
    # time the flush dispatcher spent blocked materializing device arrays
    # — the sink-gather sync points — and ``overlap_s`` is the wall-clock
    # intersection of the two.  ``overlap_frac = overlap_s/host_pack_s``:
    # the fraction of host pack work that was hidden under device waits.
    host_pack_s: float = 0.0
    device_wait_s: float = 0.0
    overlap_s: float = 0.0
    overlap_frac: float = 0.0
    # epoch-gated read lane (pipelined drivers): staged flush epochs and
    # reads that had to park waiting for their epoch to land
    epochs_staged: int = 0
    staged_reads: int = 0
    parked_reads: int = 0
    # measured-IO admission (``max_unsynced_bytes=``): submits that hit
    # the outstanding-unsynced-WAL-bytes watermark (the wait itself lands
    # in ``submit_wait_s``), and the high-water mark of outstanding bytes
    admission_waits: int = 0
    unsynced_bytes_peak: int = 0
    # byte-capped L2 (``HostL2Cache(capacity_bytes=)``): resident payload
    # bytes and rows dropped by the watermark shed loop (synced at
    # ``snapshot`` like the other l2_* columns)
    l2_bytes: int = 0
    l2_shed_rows: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class _OverlapMeter:
    """Wall-clock intersection of two activity channels (host, device).

    ``host()`` wraps driver-side group planning/packing; ``device()``
    wraps the flush dispatcher's device-array materialization waits.  The
    meter accumulates each channel's total busy time plus the time both
    were active *simultaneously* — a direct measurement of how much host
    pack work the pipeline hid under device time, not an inference from
    wall-clock arithmetic.  Each channel is non-reentrant and owned by
    one thread at a time (driver/prep thread vs dispatcher thread), which
    the sink's thread model already guarantees.
    """

    HOST, DEVICE = 0, 1

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._since: List[Optional[float]] = [None, None]
        self._both: float = 0.0
        self.total = [0.0, 0.0]
        self.overlap_s = 0.0

    def begin(self, ch: int) -> None:
        now = time.perf_counter()
        with self._lock:
            self._since[ch] = now
            if self._since[1 - ch] is not None:
                self._both = now

    def end(self, ch: int) -> None:
        now = time.perf_counter()
        with self._lock:
            since = self._since[ch]
            if since is None:  # pragma: no cover - defensive
                return
            self.total[ch] += now - since
            self._since[ch] = None
            if self._since[1 - ch] is not None:
                self.overlap_s += now - self._both

    @contextlib.contextmanager
    def host(self):
        self.begin(self.HOST)
        try:
            yield
        finally:
            self.end(self.HOST)

    @contextlib.contextmanager
    def device(self):
        self.begin(self.DEVICE)
        try:
            with tracing.span("sink.d2h"):
                yield
        finally:
            self.end(self.DEVICE)


class ReadTicket:
    """Future-like handle for an ordered hydration read.

    ``WriteBehindSink.submit_read`` routes the requested keys through the
    same FIFO pipeline as the flush blocks (dispatcher queue, then the
    owning partition's worker queue), so the batched ``multi_get`` executes
    *after* every flush submitted earlier — the write-ordering guarantee
    residency hydration relies on.  ``result()`` blocks until every
    partition's slice has landed and returns rows aligned with the
    requested key order (``None`` for absent keys).
    """

    def __init__(self, n_keys: int, n_parts: int,
                 stats: Optional[SinkStats] = None):
        self._rows: List[Optional[bytes]] = [None] * n_keys
        self._pending = n_parts
        self._done = threading.Event()
        self._exc: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._stats = stats
        if n_parts == 0:
            self._done.set()

    def _deliver(self, idx, rows, exc: Optional[BaseException] = None
                 ) -> None:
        with self._lock:
            if exc is not None:
                # failure completes the ticket immediately: a partial
                # fan-out must never strand a driver waiting on parts
                # that will not arrive
                self._exc = exc
                self._pending = 0
            else:
                for i, r in zip(idx, rows):
                    self._rows[int(i)] = r
                self._pending -= 1
            if self._pending <= 0:
                self._done.set()

    def result(self) -> List[Optional[bytes]]:
        t0 = time.perf_counter()
        self._done.wait()
        if self._stats is not None:
            self._stats.read_wait_s += time.perf_counter() - t0
        if self._exc is not None:
            raise RuntimeError("hydration read failed") from self._exc
        return self._rows


def _owned_partition_fn(route, n_partitions: int, owned):
    """``route`` (keys -> partition) as keys -> index into the owned
    stores, refusing keys of partitions not owned."""
    index = np.full(int(n_partitions), -1, np.int64)
    index[list(owned)] = np.arange(len(owned))

    def fn(keys):
        part = np.asarray(route(keys), np.int64)
        out = index[part]
        if (out < 0).any():
            raise ValueError(
                f"rows of partitions {sorted(set(part[out < 0].tolist()))} "
                f"reached a sink that owns only {tuple(owned)}: a rank "
                f"writes and reads its own partition only")
        return out

    return fn


class WriteBehindSink:
    """Asynchronous durable sink for engine block outputs.

    ``n_partitions``/``partition_fn`` route keys to partition stores
    (default: ``key % n_partitions``, the block layout);
    ``ShardedFeatureEngine.make_sink`` passes its layout's ``route``.
    ``owned``: the partitions this sink opens and writes, in the order of
    ``stores`` (default: all).  A rank of the sharded engine owns its own
    partition only: it never opens another rank's store, and a row routed
    to a partition it does not own is refused (``ValueError``, at the read
    or demote that names it, or surfaced by the next ``submit``/``flush``
    when a flushed row does).  ``partitions`` lists them.
    ``device`` names the device whose tensors the sink takes (``cuda:0``
    unless named; ``run_stream`` checks it against the state's).

    ``queue_depth`` bounds in-flight blocks (default 2 = double buffering:
    one block flushing while the next computes).  ``submit`` blocks when
    the store cannot keep up — backpressure, not unbounded buffering.
    ``queue_depth=0`` disables the background threads entirely and flushes
    synchronously inside ``submit`` — the serial-flush strawman the
    ``bench_engine --suite persist`` rows compare write-behind against.

    Flush is multi-worker: one *dispatcher* thread converts, dedupes and
    packs each block (work proportional to the block, done once), then
    hands each partition's slice to that partition's own *store worker*
    thread for the batched ``multi_put`` — so the storage path scales with
    the partition count on full-stream policies, where flush work is
    proportional to events.  Per-partition FIFO order is preserved
    (dispatcher order → store-queue order), which is also what makes
    ``submit_read`` hydration reads correctly ordered after earlier
    flushes of the same keys.

    ``backend`` selects the partition stores when none are passed in:
    ``"memory"`` (default) is the modeled in-process ``KVStore``;
    ``"durable"`` opens real WAL+memtable+compaction ``DurableStore``
    partitions under ``store_dir`` (required), recovering from disk if the
    directory already holds a previous run — see ``streaming/durable.py``.
    Both present the identical ``KVStore`` API and SerDe byte contract.

    Fault handling: every store op a flush worker issues runs under
    ``retry`` (bounded exponential backoff, default ``RetryPolicy()``) so
    transient ``OSError``s complete the run instead of poisoning it;
    exhaustion — like any other worker exception — is surfaced to the
    driver thread on the *next* ``submit()``/``flush()`` call, not just at
    ``close()``.  ``overflow`` picks the behavior when the bounded queue
    is full at ``submit()``: ``"block"`` (default) waits — pure
    backpressure — while ``"degrade-to-serial"`` drains the pipeline and
    flushes the offered block inline on the driver thread (counted in
    ``degraded_flushes``); draining first preserves per-partition FIFO
    order and the one-thread-per-store invariant, so last-write-wins
    semantics are unchanged.

    Measured-IO admission: ``max_unsynced_bytes=`` caps the payload bytes
    handed to the store workers but not yet landed (for the durable
    backend: not yet past the batch's group-commit fsync).  Above the
    watermark ``submit()`` blocks — counted in ``admission_waits`` /
    ``submit_wait_s`` — so a slow disk backpressures the engine by *real*
    write/fsync completion, not by modeled service time or queue slots.
    ``store_kw=`` forwards extra ``DurableStore`` knobs
    (``compaction="background"``, ``bloom_bits_per_key=``, ...) to the
    sink-opened partition stores.

    Thread-safety: ``submit``/``submit_read``/``flush``/``close`` are
    driver-thread calls; each store is touched by exactly one worker
    thread until ``flush``/``close`` returns.
    """

    def __init__(self, cfg: EngineConfig, *,
                 n_partitions: int = 1,
                 partition_fn: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None,
                 stores: Optional[List[KVStore]] = None,
                 storage: Optional[StorageModel] = None,
                 seed: int = 0, queue_depth: int = 2,
                 backend: str = "memory",
                 store_dir: Optional[str] = None,
                 retry: Optional[RetryPolicy] = None,
                 overflow: str = "block",
                 l2=None,
                 max_unsynced_bytes: Optional[int] = None,
                 store_kw: Optional[dict] = None,
                 owned: Optional[Sequence[int]] = None,
                 device=None):
        self.cfg = cfg
        # the device whose tensors this sink takes (cuda:0 unless named)
        self.device = resolve_device(device)
        self.serde = SerDe(len(cfg.taus))
        self.full_stream = cfg.policy in FULL_STREAM_POLICIES
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend={backend!r} "
                             f"(expected one of {BACKENDS})")
        if overflow not in OVERFLOW_POLICIES:
            raise ValueError(f"unknown overflow={overflow!r} "
                             f"(expected one of {OVERFLOW_POLICIES})")
        self._owns_stores = stores is None
        parts = range(n_partitions) if owned is None else owned
        if stores is not None:
            if store_kw:
                raise ValueError("store_kw= applies only to sink-opened "
                                 "durable stores, not explicit stores=")
            self.stores = list(stores)
            if owned is not None and len(self.stores) != len(owned):
                raise ValueError(f"{len(self.stores)} stores for the "
                                 f"{len(owned)} owned partitions")
        elif backend == "durable":
            if store_dir is None:
                raise ValueError("backend='durable' requires store_dir=")
            self.stores = open_partition_stores(
                store_dir, n_partitions, owned=parts, model=storage,
                seed=seed, **(store_kw or {}))
        else:
            if store_kw:
                raise ValueError("store_kw= requires backend='durable'")
            self.stores = [KVStore(storage or StorageModel(), seed=seed + i)
                           for i in parts]
        self.partitions = tuple(int(p) for p in owned) if owned is not None \
            else tuple(range(len(self.stores)))
        if owned is None:
            self._partition_fn = partition_fn or \
                (lambda keys: keys % len(self.stores))
        else:
            self._partition_fn = _owned_partition_fn(
                partition_fn or (lambda keys: keys % n_partitions),
                n_partitions, self.partitions)
        # Host-RAM L2 tier between the device slots and the durable store
        # (``streaming.residency.HostL2Cache``), one cache per partition so
        # each stays owned by its partition's single worker thread on the
        # write side.  ``l2=None`` disables the tier; an int builds one
        # cache of that capacity per partition; ``True`` builds unbounded
        # per-partition caches; a ``HostL2Cache`` is shared across
        # partitions (its own lock makes that safe); a sequence supplies
        # one cache per partition explicitly.
        if l2 is None:
            self.l2: Optional[List[HostL2Cache]] = None
        elif isinstance(l2, HostL2Cache):
            self.l2 = [l2] * len(self.stores)
        elif l2 is True:
            self.l2 = [HostL2Cache() for _ in self.stores]
        elif isinstance(l2, (int, np.integer)):
            self.l2 = [HostL2Cache(capacity=int(l2)) for _ in self.stores]
        else:
            self.l2 = list(l2)
            if len(self.l2) != len(self.stores):
                raise ValueError(
                    f"l2 sequence has {len(self.l2)} caches for "
                    f"{len(self.stores)} partitions")
        self.retry = retry or RetryPolicy()
        self._retry_lock = threading.Lock()
        self._overflow = overflow
        # measured-IO admission: outstanding bytes submitted to the store
        # workers but not yet landed (and group-commit-fsynced, for the
        # durable backend — the decrement happens after ``multi_put``
        # returns, which is after the WAL fsync).  ``submit()`` blocks
        # above the watermark, so a slow disk backpressures the engine by
        # real IO completion time, not by modeled service times.
        self._max_unsynced = (None if max_unsynced_bytes is None
                              else int(max_unsynced_bytes))
        if self._max_unsynced is not None and self._max_unsynced <= 0:
            raise ValueError("max_unsynced_bytes must be > 0")
        self._unsynced = 0
        self._unsynced_cv = threading.Condition()
        self.stats = SinkStats()
        self.overlap = _OverlapMeter()
        # flush groups submitted so far: the next one's number, which its
        # spans carry on every thread (``tracing``)
        self.submitted = 0
        # epoch-gated read lane (see ``stage_epoch``): key -> epoch of the
        # latest *staged* flush containing that key.  Written only by the
        # single staging thread; sized on demand.
        self._epoch_of_key = np.zeros(0, np.int64)
        self._staged_seq = 0
        self._applied = [0] * len(self.stores)
        self._park_lock = [threading.Lock() for _ in self.stores]
        self._parked: List[List[tuple]] = [[] for _ in self.stores]
        self._put_busy = [0.0] * len(self.stores)
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._serial = queue_depth == 0
        if self._serial:
            self._q = self._thread = None
            self._store_qs: List[queue.Queue] = []
            self._store_threads: List[threading.Thread] = []
        else:
            self._q = queue.Queue(maxsize=queue_depth)
            # one flush worker per partition store: the dispatcher packs,
            # the workers land bytes (FIFO per store)
            self._store_qs = [queue.Queue() for _ in self.stores]
            self._store_threads = [
                threading.Thread(target=self._store_drain, args=(i,),
                                 name=f"sink-store-{i}", daemon=True)
                for i in range(len(self.stores))]
            for th in self._store_threads:
                th.start()
            self._thread = threading.Thread(
                target=self._drain, name="write-behind-sink", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ driver
    def submit(self, keys, z, valid, rows, seq: Optional[int] = None
               ) -> None:
        """Queue one block for durable flush.

        ``keys``: [B] global entity ids; ``z``: [B] persistence decisions;
        ``valid``: [B] padding mask; ``rows``: the block's post-update
        profile rows gathered per lane — either the driver's stacked form
        ``(scalars[4, B], agg[B, T, 3])`` with scalar columns ordered
        ``[last_t, v_f, v_full, last_t_full]`` (``core.stream.
        sink_step_for``), or the flat 5-tuple ``(last_t, v_f, agg, v_full,
        last_t_full)``.  Arguments may be device arrays: the device->host
        conversion happens on the flush thread, overlapping the next
        block's compute.  Blocks (bounded queue) when ``queue_depth``
        flushes are already in flight — backpressure, not buffering.

        ``seq`` (pipelined drivers) names the flush epoch this block was
        staged as (``stage_epoch``): once the block's puts have executed,
        every partition's applied counter advances to ``seq``, releasing
        any staged reads parked on it.  Blocks carrying a ``seq`` must be
        submitted in staging order — the pipelined drivers dispatch
        groups in stream order, so this holds by construction.
        """
        if self._closed:
            # the drain thread is gone: enqueueing would silently drop
            # rows and eventually deadlock on the bounded queue
            raise RuntimeError("submit() on a closed WriteBehindSink")
        self._check()
        group, self.submitted = self.submitted, self.submitted + 1
        with tracing.span("sink.submit", group):
            self._submit(keys, z, valid, rows, seq, group)

    def _submit(self, keys, z, valid, rows, seq, group) -> None:
        if (self._max_unsynced is not None
                and self._unsynced > self._max_unsynced):
            # measured-IO admission: hold the driver until the store
            # workers have landed (and fsynced) enough outstanding bytes.
            # A single oversized block still passes at zero outstanding.
            t0 = time.perf_counter()
            self.stats.admission_waits += 1
            with self._unsynced_cv:
                while (self._unsynced > self._max_unsynced
                       and self._exc is None):
                    self._unsynced_cv.wait(0.05)
            self.stats.submit_wait_s += time.perf_counter() - t0
            self._check()
        if self._serial:
            self._flush_block(keys, z, valid, rows, seq, group)
            return
        if self._overflow == "degrade-to-serial" and self._q.full():
            # graceful degradation: drain the pipeline (preserving FIFO
            # order and the one-thread-per-store invariant — the workers
            # are idle once the queues join), then flush this block inline
            # on the driver thread instead of blocking behind the queue
            t0 = time.perf_counter()
            self._q.join()
            for sq in self._store_qs:
                sq.join()
            self._check()
            self.stats.degraded_flushes += 1
            self._flush_block(keys, z, valid, rows, seq, group, inline=True)
            self.stats.submit_wait_s += time.perf_counter() - t0
            return
        t0 = time.perf_counter()
        self._q.put(("block", keys, z, valid, rows, seq, group))
        self.stats.submit_wait_s += time.perf_counter() - t0

    def stage_epoch(self, keys, valid=None) -> int:
        """Record one flush group as *staged* and return its epoch.

        The pipelined drivers plan group *g+1* while group *g* is still on
        device, so a rehydration read for *g+1* can be submitted before
        *g*'s flush block even exists — the dispatcher-FIFO ordering the
        serial drivers rely on cannot sequence it.  The epoch lane
        replaces queue position with explicit happens-before: the staging
        thread calls ``stage_epoch(keys, valid)`` the moment a group's
        lanes are known (marking each valid key's latest staged epoch),
        later submits the flush with ``submit(..., seq=epoch)``, and
        gates reads of possibly-staged keys with ``submit_read(...,
        staged=True)`` — each such read carries, per partition, the
        maximum staged epoch over its keys and executes only once that
        partition has applied it.

        Contract (single-stager): ``stage_epoch`` and every
        ``staged=True`` read are called from one thread, in stream order,
        and a group's *own* hydration reads are submitted **before** its
        ``stage_epoch`` — a group must not wait on its own epoch.  Every
        staged epoch must eventually be submitted, or reads parked on it
        wait forever.  Keys staged but ultimately thinned (``z=False``)
        still advance the applied counter with their group — semantically
        right, since their durable row legitimately stays older.
        """
        keys = np.asarray(keys, np.int64).reshape(-1)
        if valid is not None:
            keys = keys[np.asarray(valid, bool).reshape(-1)]
        self._staged_seq += 1
        seq = self._staged_seq
        self.stats.epochs_staged += 1
        if keys.size:
            hi = int(keys.max()) + 1
            if hi > self._epoch_of_key.size:
                grown = np.zeros(max(hi, 2 * self._epoch_of_key.size, 1024),
                                 np.int64)
                grown[:self._epoch_of_key.size] = self._epoch_of_key
                self._epoch_of_key = grown
            self._epoch_of_key[keys] = seq
        return seq

    def submit_read(self, keys, ordered: bool = True, *,
                    staged: bool = False) -> ReadTicket:
        """Queue a batched read of ``keys`` (hydration path).

        ``ordered=True`` (default): the read rides the same FIFO pipeline
        as the flush blocks — dispatcher queue, then the owning
        partition's store queue — so it observes every flush submitted
        before it; per partition store, reads can never overtake earlier
        writes.  ``ordered=False`` skips the dispatcher and enqueues
        straight on the store-worker queues: the read no longer waits for
        in-flight blocks to be converted and packed.  Only correct for
        keys that cannot be in any in-flight flush — e.g. a residency
        driver's *first-touch* misses, which this run has never written
        (``streaming.residency.GroupAssignment.miss_fresh``).

        ``staged=True`` (pipelined drivers; implies the fast direct lane):
        the read carries, per partition, the maximum *staged* epoch over
        its keys (``stage_epoch``).  A store worker executes it
        immediately if that partition has already applied the epoch,
        otherwise parks it — never blocking the worker, whose queue still
        holds the very flushes the read is waiting for — and the epoch
        marker trailing the awaited flush drains the parking lot.  This
        gives exactly the serial FIFO guarantee (a read observes every
        flush *staged* before it) without riding behind the dispatcher.

        Returns a ``ReadTicket``; ``ticket.result()`` blocks until the
        rows (aligned with ``keys``, ``None`` for absent entries) are
        available.  An empty key set resolves immediately without
        touching the stores.
        """
        if self._closed:
            raise RuntimeError("submit_read() on a closed WriteBehindSink")
        self._check()
        keys = np.asarray(keys, np.int64).reshape(-1)
        if keys.size == 0:
            return ReadTicket(0, 0, self.stats)
        self.stats.reads += 1
        self.stats.rows_read += int(keys.size)
        part = np.asarray(self._partition_fn(keys))
        splits = []
        for p in np.unique(part):
            idx = np.nonzero(part == p)[0]
            splits.append((int(p), idx, keys[idx]))
        ticket = ReadTicket(int(keys.size), len(splits), self.stats)
        if staged:
            self.stats.staged_reads += 1
            eok = self._epoch_of_key
            for p, idx, ks in splits:
                inb = ks[ks < eok.size]
                need = int(np.max(eok[inb], initial=0)) if inb.size else 0
                if self._serial:
                    # no workers to park on; the single-driver contract
                    # (reads staged before their epoch's submit, submits
                    # in stage order) makes every need already applied
                    if need > self._applied[p]:
                        raise RuntimeError(
                            "staged read needs epoch "
                            f"{need} > applied {self._applied[p]} on a "
                            "serial sink (pipelined drivers require "
                            "queue_depth >= 1)")
                    ticket._deliver(idx, self._exec_get(p, ks))
                else:
                    self._store_qs[p].put(("read", ticket, idx, ks, need))
            return ticket
        if self._serial:
            for p, idx, ks in splits:
                ticket._deliver(idx, self._exec_get(p, ks))
            return ticket
        if ordered:
            self._q.put(("read", ticket, splits))
        else:
            for p, idx, ks in splits:
                self._store_qs[p].put(("read", ticket, idx, ks))
        return ticket

    def demote(self, keys) -> None:
        """Demote evicted keys into the host L2 tier (no-op without one).

        Driver-thread call at slot eviction: present entries (the
        victim's row or cached absence, written at flush/read execution
        time) get their LRU recency refreshed.  Refresh-only (see
        ``HostL2Cache.demote`` for why demote must never insert), so
        racing with the key's in-flight flush is harmless in either
        order.
        """
        if self.l2 is None:
            return
        keys = np.asarray(keys, np.int64).reshape(-1)
        if keys.size == 0:
            return
        part = np.asarray(self._partition_fn(keys))
        for p in np.unique(part):
            self.l2[int(p)].demote(keys[part == p])

    def l2_probe(self, keys):
        """Driver-side L2 lookup: ``(rows, hit)`` aligned with ``keys``.

        The partition-aware probe path for cold scoring — pass it as
        ``materialize_cold(..., l2_probe=sink.l2_probe)`` (what
        ``serving.pipeline.ScoringPipeline.score_cold`` does) so lookups
        use the same ``partition_fn`` keying the rows were inserted
        under.  Coherent with the stores only when the pipeline is
        quiescent — call after ``flush()``.  Without an L2 every key is
        a miss.
        """
        keys = np.asarray(keys, np.int64).reshape(-1)
        rows: List[Optional[bytes]] = [None] * int(keys.size)
        hit = np.zeros(keys.size, bool)
        if self.l2 is None or keys.size == 0:
            return rows, hit
        part = np.asarray(self._partition_fn(keys))
        for p in np.unique(part):
            idx = np.nonzero(part == p)[0]
            r, h = self.l2[int(p)].probe(keys[idx])
            for j, rj in zip(idx, r):
                rows[int(j)] = rj
            hit[idx] = h
        return rows, hit

    def l2_contains(self, keys) -> np.ndarray:
        """Advisory L2 presence mask (racy vs in-flight flushes; stats
        only — the serving frontend counts prefetches the tier will
        absorb).  All-False without an L2."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        if self.l2 is None or keys.size == 0:
            return np.zeros(keys.size, bool)
        out = np.zeros(keys.size, bool)
        part = np.asarray(self._partition_fn(keys))
        for p in np.unique(part):
            idx = np.nonzero(part == p)[0]
            out[idx] = self.l2[int(p)].contains(keys[idx])
        return out

    def flush(self) -> dict:
        """Block until every submitted block is durably stored."""
        self._check()
        if not self._serial:
            self._q.join()
            for sq in self._store_qs:
                sq.join()
        self._check()
        return self.snapshot()

    def close(self) -> None:
        """Drain and stop the flush threads (idempotent); stores the sink
        opened itself (``backend=``) are closed too — a durable store's
        close is its final group-commit fsync."""
        if not self._closed:
            self._closed = True
            if not self._serial:
                self._q.put(_STOP)
                self._thread.join()
                for th in self._store_threads:
                    th.join()
            if self._owns_stores:
                for s in self.stores:
                    getattr(s, "close", lambda: None)()
        self._check()

    def __enter__(self) -> "WriteBehindSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def snapshot(self) -> dict:
        """Sink + per-partition store counters, aggregated.

        Read-path columns (``gets``/``batch_gets``/``bytes_read``/
        ``modeled_read_s``) are surfaced with the same fidelity as the
        write columns, so hydration cost is observable wherever sink stats
        are recorded.  ``put_s`` is the store workers' aggregate busy time.
        """
        agg = {"puts": 0, "gets": 0, "batch_puts": 0, "batch_gets": 0,
               "bytes_written": 0, "bytes_read": 0, "modeled_io_s": 0.0,
               "modeled_read_s": 0.0, "modeled_write_s": 0.0,
               "store_serde_s": 0.0}
        for s in self.stores:
            c = s.counters
            agg["puts"] += c.puts
            agg["gets"] += c.gets
            agg["batch_puts"] += c.batch_puts
            agg["batch_gets"] += c.batch_gets
            agg["bytes_written"] += c.bytes_written
            agg["bytes_read"] += c.bytes_read
            agg["modeled_io_s"] += c.modeled_io_s
            agg["modeled_read_s"] += c.modeled_read_s
            agg["modeled_write_s"] += c.modeled_write_s
            agg["store_serde_s"] += c.serde_s
        agg["waf"] = max((s.waf() for s in self.stores), default=1.0)
        agg["put_s"] = sum(self._put_busy)
        # per-partition critical path: store workers run concurrently, so
        # the pipeline is bounded by the slowest store's put busy time +
        # modeled IO, not by their sum
        agg["store_path_s_max"] = max(
            (busy + s.counters.modeled_io_s
             for busy, s in zip(self._put_busy, self.stores)), default=0.0)
        # measured durability counters (durable backend only; the base
        # KVStore reports {}): summed across partitions, plus the measured
        # WAF — physical WAL+segment bytes per logical byte ingested —
        # reported *next to* the modeled ``waf`` column, never replacing it
        measured: dict = {}
        per_part = [s.measured() for s in self.stores]
        for m in per_part:
            for k, v in m.items():
                measured[k] = measured.get(k, 0) + v
        if measured:
            measured["measured_bytes_written"] = (
                measured.get("wal_bytes", 0) + measured.get("seg_bytes", 0))
            measured["measured_waf"] = (
                measured["measured_bytes_written"]
                / max(agg["bytes_written"], 1))
            agg["measured"] = measured
            # per-partition measured IO: the admission watermark throttles
            # on *real* write/fsync completion, so the per-store split is
            # the observable a slow-disk diagnosis needs
            agg["measured_per_partition"] = [
                {"io_write_s": round(m.get("io_write_s", 0.0), 6),
                 "io_sync_s": round(m.get("io_sync_s", 0.0), 6),
                 "wal_bytes": m.get("wal_bytes", 0),
                 "fsyncs": m.get("fsyncs", 0)} if m else {}
                for m in per_part]
        agg["unsynced_bytes"] = self._unsynced
        # host/device split: totals + measured wall-clock intersection
        self.stats.host_pack_s = self.overlap.total[_OverlapMeter.HOST]
        self.stats.device_wait_s = self.overlap.total[_OverlapMeter.DEVICE]
        self.stats.overlap_s = self.overlap.overlap_s
        self.stats.overlap_frac = (
            self.stats.overlap_s / self.stats.host_pack_s
            if self.stats.host_pack_s > 0 else 0.0)
        if self.l2 is not None:
            # dedupe by identity: a single shared cache may back every
            # partition slot
            caches = list({id(c): c for c in self.l2}.values())
            self.stats.l2_hits = sum(c.hits for c in caches)
            self.stats.l2_demotions = sum(c.demotions for c in caches)
            self.stats.l2_bytes = sum(c.bytes for c in caches)
            self.stats.l2_shed_rows = sum(c.shed_rows for c in caches)
            agg["l2_rows"] = sum(len(c) for c in caches)
            agg["l2_inserts"] = sum(c.inserts for c in caches)
            agg["l2_read_fills"] = sum(c.read_fills for c in caches)
            agg["l2_capacity_evictions"] = sum(
                c.capacity_evictions for c in caches)
        agg.update(self.stats.snapshot())
        return agg

    def _check(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("write-behind flush failed") from exc

    def _with_retry(self, fn, *args):
        """One store op under the bounded-backoff ``RetryPolicy``.

        Counters are taken under a lock (workers run concurrently); the
        final attempt's failure re-raises for the caller's normal error
        surface (worker → ``self._exc`` → next driver ``_check``).
        """
        rp = self.retry
        delay = rp.base_s
        for attempt in range(rp.retries + 1):
            try:
                return fn(*args)
            except rp.retry_on:
                with self._retry_lock:
                    self.stats.transient_errors += 1
                    if attempt >= rp.retries:
                        self.stats.flush_errors += 1
                        raise
                    self.stats.retries += 1
                    self.stats.retry_wait_s += delay
                time.sleep(delay)
                delay *= rp.factor

    # ---------------------------------------------------- flush threads
    def _drain(self) -> None:
        """Dispatcher: convert + dedupe + pack blocks, fan work out to the
        per-partition store workers, forward reads in FIFO order."""
        while True:
            item = self._q.get()
            if item is _STOP:
                for sq in self._store_qs:
                    sq.put(_STOP)
                self._q.task_done()
                return
            try:
                if item[0] == "read":
                    _, ticket, splits = item
                    for p, idx, ks in splits:
                        self._store_qs[p].put(("read", ticket, idx, ks))
                elif self._exc is None:
                    self._flush_block(*item[1:])
            except BaseException as e:       # surfaced on next driver call
                self._exc = e
                if item[0] == "read":        # never strand a waiting driver
                    item[1]._deliver((), (), exc=e)
            finally:
                self._q.task_done()

    def _store_drain(self, i: int) -> None:
        """One partition store's worker: batched puts, ordered reads,
        epoch markers (which advance ``_applied[i]`` and drain any staged
        reads parked on them)."""
        sq = self._store_qs[i]
        while True:
            item = sq.get()
            if item is _STOP:
                # fail, never strand: parked reads wait on epochs that
                # can no longer arrive
                with self._park_lock[i]:
                    parked, self._parked[i] = self._parked[i], []
                for ticket, idx, ks, need in parked:
                    ticket._deliver(idx, (), exc=RuntimeError(
                        f"sink closed with a staged read parked on "
                        f"epoch {need}"))
                sq.task_done()
                return
            try:
                if item[0] == "read":
                    ticket, idx, ks = item[1], item[2], item[3]
                    need = item[4] if len(item) > 4 else 0
                    if need > self._applied[i]:
                        parked = False
                        with self._park_lock[i]:
                            if need > self._applied[i]:
                                self._parked[i].append(
                                    (ticket, idx, ks, need))
                                self.stats.parked_reads += 1
                                parked = True
                        if parked:
                            continue
                    try:
                        ticket._deliver(idx, self._exec_get(i, ks))
                    except BaseException as e:
                        ticket._deliver(idx, (), exc=e)
                        raise
                elif item[0] == "epoch":
                    self._mark_applied(i, item[1])
                else:
                    _, ks, rows, nbytes, group = item
                    try:
                        if self._exc is None:
                            self._exec_put(i, ks, rows, group)
                    finally:
                        # always release the admission budget — including
                        # the skipped-on-poison path, or a blocked
                        # ``submit()`` could outlive the error it should
                        # be surfacing
                        self._unsynced_sub(nbytes)
            except BaseException as e:
                self._exc = e
            finally:
                sq.task_done()

    def _mark_applied(self, p: int, seq: int) -> None:
        """Advance partition ``p``'s applied epoch and run any staged
        reads whose need it satisfies.  Runs on the partition's worker
        thread (epoch marker) or the driver thread (serial sink), so the
        one-thread-at-a-time-per-store invariant holds either way."""
        with self._park_lock[p]:
            if seq > self._applied[p]:
                self._applied[p] = seq
            applied = self._applied[p]
            runnable = [e for e in self._parked[p] if e[3] <= applied]
            if runnable:
                self._parked[p] = [e for e in self._parked[p]
                                   if e[3] > applied]
        for ticket, idx, ks, _need in runnable:
            try:
                ticket._deliver(idx, self._exec_get(p, ks))
            except BaseException as e:
                ticket._deliver(idx, (), exc=e)
                raise

    @staticmethod
    def _payload_bytes(rows) -> int:
        """Logical payload bytes of one partition's packed rows (the unit
        the ``max_unsynced_bytes`` watermark is counted in; WAL framing
        adds a small constant per batch on top)."""
        if isinstance(rows, np.ndarray):
            return int(rows.nbytes)
        return sum(len(r) for r in rows)

    def _put(self, p: int, keys, rows, group: Optional[int],
             inline: bool = False) -> None:
        """Route one partition's packed rows to its store (worker thread,
        or directly under the serial strawman / a degraded flush)."""
        nbytes = self._payload_bytes(rows)
        self._unsynced_add(nbytes)
        if self._serial or inline:
            try:
                self._exec_put(p, keys, rows, group)
            finally:
                self._unsynced_sub(nbytes)
        else:
            self._store_qs[p].put(("put", keys, rows, nbytes, group))

    def _unsynced_add(self, nbytes: int) -> None:
        with self._unsynced_cv:
            self._unsynced += nbytes
            if self._unsynced > self.stats.unsynced_bytes_peak:
                self.stats.unsynced_bytes_peak = self._unsynced

    def _unsynced_sub(self, nbytes: int) -> None:
        with self._unsynced_cv:
            self._unsynced -= nbytes
            self._unsynced_cv.notify_all()

    def _exec_put(self, p: int, keys, rows,
                  group: Optional[int] = None) -> None:
        """Execute one partition's batched put, then mirror the packed
        bytes into its L2 cache — insertion at put *execution* time on the
        partition's single writer thread is what keeps every later ordered
        read's L2 view identical to the store's."""
        t0 = time.perf_counter()
        with tracing.span("sink.put", group):
            self._with_retry(self.stores[p].multi_put, keys, rows)
            if self.l2 is not None:
                self.l2[p].put_rows(keys, rows)
        self._put_busy[p] += time.perf_counter() - t0

    def _exec_get(self, p: int, keys):
        """Execute one partition's batched hydration read, L2 first.

        Keys resident in the partition's host cache — including cached
        absences — are answered from packed host bytes (bit-identical to
        the store row by the put-time insertion above); only the rest
        issue the durable ``multi_get``, and its results (rows *and*
        authoritative absences) are filled back into the cache so repeat
        hydrations of the same key skip the store.  Runs on the
        partition's worker thread (ordered lane), the serial strawman's
        driver thread, or the unordered fast lane — all safe, see
        ``HostL2Cache``.
        """
        if self.l2 is None:
            return self._with_retry(self.stores[p].multi_get, keys)
        rows, hit = self.l2[p].probe(keys)
        miss = np.nonzero(~hit)[0]
        if miss.size:
            miss_keys = np.asarray(keys)[miss]
            got = self._with_retry(self.stores[p].multi_get, miss_keys)
            self.l2[p].fill_from_read(miss_keys, got)
            for j, r in zip(miss, got):
                rows[int(j)] = r
        return rows

    def _flush_block(self, keys, z, valid, rows, seq: Optional[int] = None,
                     group: Optional[int] = None,
                     inline: bool = False) -> None:
        with tracing.span("sink.flush", group):
            self._flush_rows(keys, z, valid, rows, seq, group, inline)

    def _flush_rows(self, keys, z, valid, rows, seq, group, inline):
        t0 = time.perf_counter()
        # flush groups arrive with z shaped [G, B]; lanes are flat below.
        # The ``_host`` conversions below are the sink-gather sync
        # points: materializing ``z`` (and the gathered rows) waits for
        # the group's device compute, so they run under the overlap
        # meter's device channel — that wait is exactly the device time
        # a pipelined driver can hide host pack work beneath.
        with self.overlap.device():
            keys = _host(keys).reshape(-1)
            z = _host(z).reshape(-1)
        valid = _host(valid).reshape(-1)
        st = self.stats
        st.blocks += 1
        st.events_seen += int(valid.sum())
        selected = valid & (np.ones_like(z) if self.full_stream else z)
        idx = np.nonzero(selected)[0]
        st.selected += idx.size
        if idx.size:
            # last-write-wins dedupe: rows are end-of-block snapshots, so
            # any one lane of a key already holds the key's final row.
            uk, first = np.unique(keys[idx], return_index=True)
            pick = idx[first]
            st.rows_stored += uk.size
            st.dedup_saved += idx.size - uk.size
            if len(rows) == 2:
                # stacked driver form: (scalars[4, B], agg).  Fetched
                # whole-block (two fixed-shape host reads) — selecting on
                # device first would re-trace a gather per distinct
                # selection size, which costs far more than the copy.
                with self.overlap.device():
                    scal = _host(rows[0])[:, pick]
                    agg = _host(rows[1])[pick]
                last_t, v_f, v_full, last_t_full = scal
            else:
                with self.overlap.device():
                    last_t, v_f, agg, v_full, last_t_full = \
                        tuple(_host(r)[pick] for r in rows)
            if not self.full_stream:
                # control column is not durable under thinning policies
                v_full = np.zeros_like(v_full)
                last_t_full = np.full_like(last_t_full, -np.inf)
            ts = time.perf_counter()
            packed = self.serde.pack_rows(last_t, v_f, agg, v_full,
                                          last_t_full)
            st.serde_s += time.perf_counter() - ts
            part = self._partition_fn(uk)
            for p in np.unique(part):
                m = part == p
                self._put(int(p), uk[m], packed[m], group, inline=inline)
        if seq is not None:
            # epoch marker trails the block's puts on *every* partition
            # (even ones this block wrote nothing to): once a partition
            # processes it, every put of epochs <= seq has executed there
            if self._serial or inline:
                for p in range(len(self.stores)):
                    self._mark_applied(p, seq)
            else:
                for sq in self._store_qs:
                    sq.put(("epoch", seq))
        st.flush_s += time.perf_counter() - t0


def hydrate_state(stores: Sequence[KVStore], num_rows: int, n_taus: int,
                  row_of_key: Optional[np.ndarray] = None,
                  device=None) -> ProfileState:
    """Rebuild a ``ProfileState`` from durable bytes (restart-from-store).

    Scans every partition store (batched ``multi_get`` over its sorted key
    set — the modeled recovery IO is accounted on the store counters),
    decodes rows with the vectorized SerDe and scatters them into a fresh
    state.  ``row_of_key`` maps global entity ids to state rows for sharded
    layouts (block/virtual flat rows); identity when omitted.

    Exactness: stored persisted columns are bit-exact f32 round-trips of
    the engine state, and unstored rows equal ``init_state`` defaults, so
    the result's ``last_t``/``v_f``/``agg`` match the in-memory exact-mode
    state bit-for-bit.  The control column matches too under full-stream
    policies; under thinning policies it restarts cold (0.0 / -inf) by
    design — see the module docstring.
    """
    serde = SerDe(n_taus)
    last_t = np.full(num_rows, -np.inf, np.float32)
    v_f = np.zeros(num_rows, np.float32)
    agg = np.zeros((num_rows, n_taus, 3), np.float32)
    v_full = np.zeros(num_rows, np.float32)
    last_t_full = np.full(num_rows, -np.inf, np.float32)
    for p, store in enumerate(stores):
        ks = np.asarray(store.keys(), np.int64)
        if ks.size == 0:
            continue
        raws = store.multi_get(ks)
        lt, vf, ag, vfl, ltf = serde.unpack_rows(raws, keys=ks, partition=p)
        rows = row_of_key[ks] if row_of_key is not None else ks
        last_t[rows] = lt.astype(np.float32)
        v_f[rows] = vf.astype(np.float32)
        agg[rows] = ag
        v_full[rows] = vfl.astype(np.float32)
        last_t_full[rows] = ltf.astype(np.float32)
    return state_from_numpy(last_t, v_f, agg, v_full, last_t_full,
                            device=device)
