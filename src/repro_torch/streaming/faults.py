"""Deterministic fault injection for the durable backend (PyTorch port).

The counterpart of ``repro.streaming.faults``.  ``streaming/durable.py``
exposes every byte it moves through a ``FileOps`` seam; this module plugs
failure into that seam so the crash-safety claims are *tested*, not
asserted:

* **torn writes** — ``FaultPlan.kill_at_write`` SIGKILLs the process after
  ``kill_partial_bytes`` of the Nth WAL append have reached the OS: a real
  torn tail, produced the way a real crash produces one (the parent test
  driver then recovers the directory and checks bit-exactness), and
  ``truncate_at`` manufactures the same state post hoc;
* **bit flips** — ``flip_bit`` corrupts one bit of an on-disk file, which
  recovery must *refuse* (``CorruptionError``), never silently absorb;
* **transient errors** — ``transient_at``/``transient_every`` raise
  ``TransientIOError`` (an ``OSError``) on chosen WAL appends; the
  write-behind sink's bounded-backoff retry must complete the run with no
  data loss (``DurableStore._append_batch`` is failure-atomic, so a retried
  batch never leaves a torn record mid-file);
* **slow IO** — ``stall_s`` sleeps on every WAL append, driving the sink's
  bounded queue into backpressure / overflow handling; ``StallingReads``
  does the same to the read path the serving frontend hydrates through.

The second half is the kill-mid-flush protocol.  Run as a module
(``python -m repro_torch.streaming.faults --dir ... [--device cpu]``),
this file is the *victim*: it streams ``crash_stream`` chunks through the
port's engine on ``--device`` (the card unless named) with a serial
durable sink (one flush group per chunk, so one WAL append per chunk),
prints ``ACK <events>`` after each durable chunk, and is SIGKILLed by its
own fault plan mid-append.  On the card it loads the built kernel from
the checkout's ``build/repro_torch/`` (building it if absent) and fails if
it cannot: it never falls back to the CPU.  ``spawn_kill_mid_flush`` is
the parent half: it launches the victim, collects the ACKs, and returns
them for the caller to compare against ``run_reference`` — an
uninterrupted in-memory run over exactly the acknowledged event prefix,
on the same device.  The comparison is byte-for-byte because the engine's
thinning RNG is counter-based on (entity, time bits) and rows are
end-of-group snapshots, so results are prefix- and chunking-invariant
(see ``streaming/persistence.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import subprocess
import sys
import time
from typing import FrozenSet, List, Optional, Tuple

import numpy as np

from repro_torch.streaming.durable import (SEG_SUFFIX, WAL_NAME,
                                           DurableStore, FileOps)

__all__ = ["TransientIOError", "FaultPlan", "FaultyFileOps",
           "StallingReads", "flip_bit", "truncate_at", "crash_cfg",
           "crash_stream", "run_reference", "spawn_kill_mid_flush"]


class TransientIOError(OSError):
    """Injected retryable fault (an ``OSError``, so it matches the sink's
    default ``RetryPolicy.retry_on``)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to inject, keyed on the 1-indexed WAL append count.

    The WAL append is the unit because group commit makes it the unit of
    durability: one sink flush group = one ``multi_put`` = one append.
    ``transient_*`` faults fire *before* any byte is written, so a retry
    simply re-runs the append under the next count; ``kill_at_write``
    writes ``kill_partial_bytes`` of the record (clamped below a full
    record so the tail is genuinely torn) and SIGKILLs the process.

    ``kill_at_seg_write`` is the background-compaction counterpart: it
    counts ``write`` calls on *unpublished* segment files (``*.seg.tmp``,
    the pre-rename build target) and SIGKILLs after
    ``kill_seg_partial_bytes`` of the Nth such write reach the OS — the
    crash lands strictly before the atomic rename, so recovery must
    discard the torn ``.tmp`` and replay the still-intact WAL.
    """
    transient_at: FrozenSet[int] = frozenset()
    transient_every: int = 0
    fail_always: bool = False
    stall_s: float = 0.0
    kill_at_write: int = 0
    kill_partial_bytes: int = 24
    kill_at_seg_write: int = 0
    kill_seg_partial_bytes: int = 4096

    def wants_transient(self, n: int) -> bool:
        return (self.fail_always or n in self.transient_at
                or (self.transient_every > 0
                    and n % self.transient_every == 0))


class _FaultyFile:
    """WAL file proxy: every ``write`` consults the plan first."""

    def __init__(self, f, ops: "FaultyFileOps"):
        self._f = f
        self._ops = ops

    def write(self, buf) -> int:
        ops = self._ops
        plan = ops.plan
        ops.wal_writes += 1
        n = ops.wal_writes
        if plan.stall_s > 0.0:
            time.sleep(plan.stall_s)
        if plan.kill_at_write and n == plan.kill_at_write:
            k = min(int(plan.kill_partial_bytes), max(len(buf) - 1, 0))
            self._f.write(buf[:k])
            self._f.flush()         # push the torn prefix to the OS
            os.kill(os.getpid(), signal.SIGKILL)
        if plan.wants_transient(n):
            ops.injected_transients += 1
            raise TransientIOError(f"injected transient fault on WAL "
                                   f"append #{n}")
        return self._f.write(buf)

    def __getattr__(self, name):
        return getattr(self._f, name)


class _FaultySegFile:
    """Unpublished-segment (``*.seg.tmp``) proxy: the kill fires mid-build,
    strictly before the atomic rename publishes the segment."""

    def __init__(self, f, ops: "FaultyFileOps"):
        self._f = f
        self._ops = ops

    # the segment build opens its target as a context manager; dunder
    # lookups bypass __getattr__, so delegate them explicitly
    def __enter__(self):
        self._f.__enter__()
        return self

    def __exit__(self, *exc):
        return self._f.__exit__(*exc)

    def write(self, buf) -> int:
        ops = self._ops
        plan = ops.plan
        ops.seg_writes += 1
        if (plan.kill_at_seg_write
                and ops.seg_writes == plan.kill_at_seg_write):
            k = min(int(plan.kill_seg_partial_bytes), max(len(buf) - 1, 0))
            self._f.write(buf[:k])
            self._f.flush()     # push the torn .tmp prefix to the OS
            os.kill(os.getpid(), signal.SIGKILL)
        return self._f.write(buf)

    def __getattr__(self, name):
        return getattr(self._f, name)


class FaultyFileOps(FileOps):
    """``FileOps`` that wraps writable WAL handles in ``_FaultyFile`` and
    in-flight segment builds (``*.seg.tmp``) in ``_FaultySegFile``.

    Counts are process-wide per instance (``wal_writes``, ``seg_writes``,
    ``injected_transients``) so a test can assert exactly how many faults
    fired.  Published segments and sidecar indexes pass through untouched —
    the WAL append and the pre-rename segment build are the deterministic
    injection points.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.wal_writes = 0
        self.seg_writes = 0
        self.injected_transients = 0

    def open(self, path: str, mode: str):
        f = super().open(path, mode)
        name = os.path.basename(path)
        writable = "a" in mode or "+" in mode or "w" in mode
        if name == WAL_NAME and writable:
            return _FaultyFile(f, self)
        if name.endswith(SEG_SUFFIX + ".tmp") and writable:
            return _FaultySegFile(f, self)
        return f


class StallingReads:
    """Store proxy that delays every batched read (``multi_get``).

    The WAL seam above injects faults into the *write* path; this is the
    matching seam for the *read* path the serving tier's prefetched
    hydration depends on (``serving/frontend.py``): each ``multi_get``
    sleeps ``stall_s`` real seconds on the sink's store-worker thread
    before delegating, and ``stalled_gets`` counts how many reads were
    held up.  Everything else — ``multi_put``, ``keys``, counters —
    passes straight through, so a stalled read can delay a dispatch but
    never change what it observes: the FIFO ordering guarantees of
    ``WriteBehindSink.submit_read`` are untouched.
    """

    def __init__(self, store, stall_s: float):
        self._store = store
        self.stall_s = float(stall_s)
        self.stalled_gets = 0

    def multi_get(self, keys):
        self.stalled_gets += 1
        if self.stall_s > 0.0:
            time.sleep(self.stall_s)
        return self._store.multi_get(keys)

    def __getattr__(self, name):
        return getattr(self._store, name)


# ------------------------------------------------------ post-hoc corruption
def flip_bit(path: str, offset: int, bit: int = 0) -> None:
    """Flip one bit of an on-disk file (bit-flip / medium corruption)."""
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        if len(b) != 1:
            raise ValueError(f"{path}: offset {offset} past end of file")
        f.seek(offset)
        f.write(bytes([b[0] ^ (1 << bit)]))


def truncate_at(path: str, k: int) -> None:
    """Truncate a file at byte ``k`` (manufactured torn write)."""
    with open(path, "r+b") as f:
        f.truncate(k)


# ------------------------------------------------- kill-mid-flush protocol
CRASH_N_KEYS = 64
CRASH_BATCH = 128
CRASH_GROUP = 2         # blocks per flush group ⇒ chunk = 256 events


def crash_cfg(policy: str):
    """Small-but-real engine config shared by victim and reference (both
    sides must agree exactly — the comparison is bit-for-bit)."""
    from repro_torch.core.types import EngineConfig
    return EngineConfig(taus=(60.0, 3600.0), h=600.0, budget=0.002,
                        alpha=1.0, policy=policy, fixed_rate=0.3,
                        mu_tau_index=1, exact_rounds=64)


CRASH_MAX_EVENTS = 8192


def crash_stream(n_events: int, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic event stream for the crash protocol (both processes
    regenerate it from the seed; nothing is piped between them).

    Always drawn at the full ``CRASH_MAX_EVENTS`` length and sliced, so a
    shorter request is an exact *prefix* of a longer one — the victim
    (full stream) and the reference (acknowledged prefix) must see
    identical events, and column-at-a-time RNG draws would otherwise make
    the q/t columns depend on the requested length.
    """
    if n_events > CRASH_MAX_EVENTS:
        raise ValueError(f"n_events={n_events} > {CRASH_MAX_EVENTS}")
    r = np.random.default_rng(seed)
    keys = r.integers(0, CRASH_N_KEYS, CRASH_MAX_EVENTS).astype(np.int64)
    qs = r.gamma(2.0, 1.0, CRASH_MAX_EVENTS).astype(np.float32)
    ts = np.cumsum(r.exponential(0.05, CRASH_MAX_EVENTS)).astype(np.float32)
    return keys[:n_events], qs[:n_events], ts[:n_events]


def _chunk_events() -> int:
    return CRASH_BATCH * CRASH_GROUP


def _run_chunks(policy: str, mode: str, n_chunks: int, seed: int, store,
                device, after_chunk=None) -> None:
    """The chunked stream both halves run: ``n_chunks`` chunks of
    ``crash_stream`` through the port's ``run_stream`` on ``device`` with a
    serial sink on ``store``, flushed after every chunk (one flush group a
    chunk); ``after_chunk(events_so_far)`` runs after each flush."""
    from repro_torch.core.stream import run_stream
    from repro_torch.core.thinning import prng_key
    from repro_torch.core.types import init_state
    from repro_torch.streaming.persistence import WriteBehindSink

    cfg = crash_cfg(policy)
    sink = WriteBehindSink(cfg, stores=[store], queue_depth=0,
                           device=device)
    chunk = _chunk_events()
    keys, qs, ts = crash_stream(n_chunks * chunk, seed)
    state = init_state(CRASH_N_KEYS, len(cfg.taus), device=device)
    rng = prng_key(0)
    for lo in range(0, len(keys), chunk):
        state, _ = run_stream(cfg, state, keys[lo:lo + chunk],
                              qs[lo:lo + chunk], ts[lo:lo + chunk],
                              batch=CRASH_BATCH, mode=mode, rng=rng,
                              collect_info=False, sink=sink,
                              sink_group=CRASH_GROUP)
        sink.flush()
        if after_chunk is not None:
            after_chunk(min(lo + chunk, len(keys)))
    sink.close()


def run_reference(policy: str, mode: str, n_events: int, seed: int = 0,
                  device=None):
    """Uninterrupted run over the first ``n_events`` events on ``device``
    (the card unless named), serial sink on a plain in-memory ``KVStore``.
    Returns the store (its ``.data`` is the byte-exact expectation for a
    recovered durable store).  Same chunking as the victim: flush-group
    boundaries line up exactly (results are chunking-invariant, but
    identical dispatch keeps the two programs structurally identical)."""
    from repro_torch.core.types import resolve_device
    from repro_torch.streaming.kvstore import KVStore

    chunk = _chunk_events()
    if n_events % chunk:
        raise ValueError(f"n_events={n_events} is not a whole number of "
                         f"{chunk}-event chunks")
    store = KVStore(seed=0)
    _run_chunks(policy, mode, n_events // chunk, seed, store,
                resolve_device(device))
    return store


def _victim_main(argv: Optional[List[str]] = None) -> None:
    """The process that gets killed: chunked stream through a serial
    durable sink, ``ACK <events>`` after each durable chunk."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--policy", required=True)
    ap.add_argument("--mode", default="exact", choices=("exact", "fast"))
    ap.add_argument("--n-chunks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-at-write", type=int, default=0)
    ap.add_argument("--kill-partial-bytes", type=int, default=24)
    ap.add_argument("--kill-at-seg-write", type=int, default=0)
    ap.add_argument("--compaction", default="inline",
                    choices=("inline", "background"))
    ap.add_argument("--compact-threshold", type=int, default=1 << 40)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    from repro_torch.core.types import resolve_device

    device = resolve_device(args.device)
    plan = FaultPlan(kill_at_write=args.kill_at_write,
                     kill_partial_bytes=args.kill_partial_bytes,
                     kill_at_seg_write=args.kill_at_seg_write)
    # one partition, serial sink; with the huge default threshold
    # compaction never triggers and exactly one WAL append lands per
    # non-empty flush group, so kill_at_write=N dies in chunk N.  The
    # background-kill matrix instead passes a tiny --compact-threshold and
    # --kill-at-seg-write so the compactor thread dies mid-segment-build
    # at a nondeterministic point in the chunk sequence (close() joins the
    # compactor, so a crossed threshold guarantees the kill fires before
    # CLEAN is printed).
    store = DurableStore(args.dir, fileops=FaultyFileOps(plan),
                         compaction=args.compaction,
                         compact_threshold_bytes=args.compact_threshold)
    # group commit done: the chunk is durable — say so, then carry on
    _run_chunks(args.policy, args.mode, args.n_chunks, args.seed, store,
                device, lambda n: print(f"ACK {n}", flush=True))
    store.close()
    print("CLEAN", flush=True)


def spawn_kill_mid_flush(store_dir: str, *, policy: str, mode: str,
                         kill_at_write: int = 0, n_chunks: int = 4,
                         seed: int = 0, timeout_s: float = 300.0,
                         kill_at_seg_write: int = 0,
                         compaction: str = "inline",
                         compact_threshold: int = 1 << 40, device=None):
    """Run the victim process to its SIGKILL; returns
    ``(returncode, acked_events, stderr)``.

    ``returncode == -signal.SIGKILL`` and ``acked_events`` (the largest
    ``ACK``, 0 if none) tell the caller which durable prefix the recovered
    store must cover.  For ``kill_at_write`` the kill is synchronous with
    the append, so recovery equals the acked prefix exactly; for
    ``kill_at_seg_write`` (background-compaction kill) the compactor
    thread dies at an arbitrary point relative to the foreground chunks,
    so recovery equals *some* whole-chunk prefix ``>= acked_events``.
    ``device`` is passed on as the victim's ``--device`` (omitted: the
    victim runs on the card).  The victim inherits the environment, with
    this package's source directory put first on ``PYTHONPATH``.
    """
    cmd = [sys.executable, "-m", "repro_torch.streaming.faults",
           "--dir", store_dir, "--policy", policy, "--mode", mode,
           "--n-chunks", str(n_chunks), "--seed", str(seed),
           "--kill-at-write", str(kill_at_write),
           "--kill-at-seg-write", str(kill_at_seg_write),
           "--compaction", compaction,
           "--compact-threshold", str(compact_threshold)]
    if device is not None:
        cmd += ["--device", str(device)]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout_s, env=env)
    acks = [int(ln.split()[1]) for ln in proc.stdout.splitlines()
            if ln.startswith("ACK ")]
    return proc.returncode, (max(acks) if acks else 0), proc.stderr


if __name__ == "__main__":
    _victim_main()
