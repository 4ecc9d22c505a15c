"""Crash-safe embedded durable backend: WAL + memtable + compaction.

``streaming/kvstore.py`` keeps the SerDe byte contract real but *models*
the storage medium (a dict plus Gamma-distributed service times) — a crash
anywhere in the write-behind pipeline silently loses everything and the
``modeled_io_s``/WAF columns are simulations.  ``DurableStore`` is the real
thing at container scale: an embedded append-only store with the same
``get/put/multi_get/multi_put/keys`` surface as ``KVStore`` (it *is* a
``KVStore`` subclass — every parity test in ``tests/test_persistence.py``
applies backend-agnostically), whose bytes actually land on disk:

* **Write-ahead log.**  Every ``put``/``multi_put`` appends one *batch
  record* to ``wal.log`` — header (magic, monotonic seq, row count, body
  length, header CRC32), body (key/length-prefixed SerDe rows) and a
  commit footer whose CRC32 chains header and body.  A batch is atomic:
  recovery applies it only when its commit footer validates, so a durable
  store never exposes half a flush group.
* **Group commit.**  One ``multi_put`` is one batch record written with a
  single ``write`` and (by default) a single ``fsync`` — and the
  write-behind sink issues exactly one ``multi_put`` per partition per
  flush group, so the fsync boundary *is* the engine's flush-group
  boundary (``core.stream.run_stream(sink=, sink_group=)``): a crash loses
  at most the uncommitted tail, never a committed group.
* **Memtable.**  ``self.data`` (the inherited dict) doubles as the
  memtable: reads are served from memory, the log is write-only until
  recovery.  The modeled service-time accounting of the base class keeps
  running unchanged, so modeled and measured columns can be reported side
  by side.
* **Compaction.**  When the WAL exceeds ``compact_threshold_bytes`` the
  memtable is written as one sorted segment file — *blocked*: up to
  ``seg_block_rows`` rows per batch record, so each block covers a
  contiguous key range — the WAL is truncated and older segments are
  removed.  Crash ordering: segment → fsync → atomic rename → dir fsync →
  WAL truncate → stale-segment unlink; a crash between any two steps
  recovers correctly because replay is seq-guarded (below).
* **Background compaction.**  ``compaction="inline"`` (default) runs the
  rewrite synchronously on the writer thread — byte-for-byte the historic
  behavior, and the mode the crash matrix pins.  ``compaction="background"``
  moves it to a per-store compactor thread: the threshold check costs two
  counter reads, the trigger sets an event, and the compactor snapshots the
  memtable at trigger time (``dict`` copy under the store mutex), reserves
  a seq block for the segment, and builds/publishes the segment while
  concurrent ``multi_put``/``multi_get`` proceed against the live
  memtable.  Appends that land during the build carry seqs *above* the
  reserved block, so instead of truncating the whole WAL the compactor
  rewrites the uncovered tail into a fresh log (write → fsync → rename →
  dir fsync — the same ordering argument; the seq guard makes every crash
  window safe).  ``compact_rate_bytes_per_s=`` token-bucket-limits segment
  write bytes so a compaction burst cannot starve foreground WAL fsyncs;
  a compactor error poisons the store and surfaces on the next write /
  ``close()`` (and through the sink, on the next ``submit()``/``flush()``).
* **Segment bloom filter.**  ``bloom_bits_per_key=`` > 0 builds a bloom
  filter over the segment's keys at compaction time and persists it as a
  CRC'd trailer of the ``.idx`` sidecar.  A cold probe consults the filter
  before the min/max fences, so point misses *inside* a block's key range
  skip the block read entirely (``bloom_probes``/``bloom_skips``/
  ``bloom_false_positives``).  Like the rest of the sidecar it is derived
  data: any damage degrades to the eager replay, never to wrong answers —
  a present key is never skipped, a false positive only costs a block read.
* **Sparse segment index.**  Each segment gets a CRC'd sidecar
  (``seg-*.idx``): per block, min key, max key, byte offset and length.
  ``lazy_recovery=True`` reopens without reading the segment at all — the
  WAL replays into the memtable as usual, and a cold ``get``/``multi_get``
  miss binary-searches the index and faults in only the one block whose
  key range covers the key (``seg_probes``/``seg_blocks_read``/
  ``seg_blocks_skipped`` count the work; a block, once read, folds into
  the memtable without clobbering newer WAL rows).  The index is derived
  data: written after its segment, and a missing, stale or corrupt
  sidecar (``index_fallbacks``) degrades to the eager full-file replay —
  never to wrong answers.

Recovery (``DurableStore(path)`` on an existing directory) replays segments
in ascending seq order, then WAL batches, skipping any batch whose seq is
not greater than the last applied one — which makes replay *idempotent*
(replaying a log prefix twice equals once) and makes the
crash-mid-compaction window safe (stale WAL batches older than the segment
are ignored).  Failure classification is deterministic:

* a record whose claimed extent runs past end-of-file is a **torn write**
  (the single-writer append-only discipline means a process kill can only
  truncate the tail): the tail is dropped, the file repaired by
  truncation, and ``torn_tails`` counts it;
* a record whose bytes are all present but whose header or commit CRC
  fails is **corruption** (bit flip / medium error): recovery raises
  ``CorruptionError`` naming the file and offset — silent data loss is
  never an option.

``streaming/faults.py`` injects exactly these failure modes through the
``fileops`` seam, and ``tests/test_durable.py`` pins the kill-mid-flush
contract: SIGKILL mid-write, then ``hydrate_state`` from the reopened
store, equals an uninterrupted run over the acknowledged prefix bit for
bit, for every policy in both engine modes.
"""
from __future__ import annotations

import bisect
import dataclasses
import fcntl
import os
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.streaming.kvstore import KVStore, StorageModel

__all__ = ["DurableStore", "DurableCounters", "CorruptionError", "FileOps",
           "PartitionLockedError", "open_partition_stores", "BACKENDS",
           "COMPACTION"]

# Persistence backends the write-behind sink can sit on
# (``WriteBehindSink(backend=...)`` / ``ShardedFeatureEngine.make_sink``).
# README.md documents each; scripts/check_docs.py lints the two lists
# against each other (same pattern as LAYOUTS / EVICTION).
BACKENDS = ("memory", "durable")

# Where the WAL->segment rewrite runs (``DurableStore(compaction=...)``):
# "inline" on the writer thread at the threshold check (the historic,
# crash-matrix-pinned default), "background" on a per-store compactor
# thread with snapshot-at-trigger semantics.  README.md documents each;
# scripts/check_docs.py lints the two lists against each other.
COMPACTION = ("inline", "background")

WAL_NAME = "wal.log"
LOCK_NAME = "LOCK"
SEG_SUFFIX = ".seg"
IDX_SUFFIX = ".idx"

_BATCH_MAGIC = 0x57414C31       # 'WAL1'
_COMMIT_MAGIC = 0x434D5431      # 'CMT1'
_HDR = struct.Struct("<IQII")   # magic, seq, n_rows, body_len
_HDR_CRC = struct.Struct("<I")
_ROW = struct.Struct("<qI")     # key, row_len
_FOOT = struct.Struct("<II")    # commit magic, body crc (chained on header)
HEADER_BYTES = _HDR.size + _HDR_CRC.size
FOOTER_BYTES = _FOOT.size

_IDX_MAGIC = 0x53494431         # 'SID1' (segment index v1)
_IDX_HDR = struct.Struct("<IIQQ")   # magic, n_blocks, first_seq, last_seq
_IDX_ENT = struct.Struct("<qqQI")   # min_key, max_key, offset, block_len

_BLM_MAGIC = 0x424C4D31         # 'BLM1' (sidecar bloom trailer v1)
_BLM_HDR = struct.Struct("<IIQ")    # magic, n_hashes, n_bits

# Chunk size for rate-limited segment writes: small enough that the token
# bucket interleaves sleeps with writes, large enough to stay sequential.
_COMPACT_CHUNK = 256 * 1024


class CorruptionError(RuntimeError):
    """Checksum mismatch on fully-present bytes: a bit flip or medium
    error, not a torn tail.  Recovery refuses to guess — it names the file
    and byte offset and stops."""


class PartitionLockedError(RuntimeError):
    """The store's directory is open in another process (two writers on
    one WAL would corrupt it)."""


class FileOps:
    """The file layer seam: every byte ``DurableStore`` moves goes through
    one of these methods, so ``streaming.faults.FaultyFileOps`` can inject
    torn writes, transient errors, stalls and kill points deterministically
    without monkey-patching ``os``."""

    def open(self, path: str, mode: str):
        return open(path, mode)

    def fsync(self, f) -> None:
        f.flush()
        os.fsync(f.fileno())

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def remove(self, path: str) -> None:
        os.remove(path)

    def fsync_dir(self, path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


@dataclasses.dataclass
class DurableCounters:
    """Measured (not modeled) durability accounting.

    ``wal_bytes``/``seg_bytes`` are physical bytes appended to the log and
    written to segment files; together with the base class's logical
    ``bytes_written`` they give the *measured* write amplification
    (``DurableStore.measured_waf``) the bench persist suite reports next
    to the modeled column.
    """
    fsyncs: int = 0
    wal_bytes: int = 0
    seg_bytes: int = 0
    seg_index_bytes: int = 0
    compactions: int = 0
    batches: int = 0
    # sparse-index read path (lazy recovery / cold reads)
    seg_probes: int = 0             # cold lookups that consulted the index
    seg_probe_hits: int = 0         # ... whose key the segment held
    seg_blocks_read: int = 0        # blocks faulted into the memtable
    seg_blocks_skipped: int = 0     # probes answered by min/max alone
    seg_bytes_read: int = 0         # physical bytes of faulted blocks
    index_fallbacks: int = 0        # missing/stale/corrupt sidecar ->
    #                                 eager full-file replay
    # segment bloom filter (sidecar trailer, bloom_bits_per_key= > 0)
    bloom_probes: int = 0           # cold probes that consulted the filter
    bloom_skips: int = 0            # ... answered "absent" with zero I/O
    bloom_false_positives: int = 0  # ... that passed but the key was absent
    # compaction placement (compaction="inline" | "background")
    compaction_stall_s: float = 0.0  # inline rewrites riding the flush path
    compact_throttle_s: float = 0.0  # token-bucket sleeps (rate limiter)
    wal_tail_rewrites: int = 0      # background WAL swaps (uncovered tail
    #                                 rewritten instead of truncate(0))
    compactions_skipped: int = 0    # no-op triggers (WAL already empty)
    # recovery-side
    recovered_batches: int = 0
    stale_batches_skipped: int = 0
    torn_tails: int = 0
    torn_bytes_dropped: int = 0
    recovery_s: float = 0.0
    # measured wall time inside write/fsync calls
    io_write_s: float = 0.0
    io_sync_s: float = 0.0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


def _encode_batch(seq: int, keys: Sequence[int], rows: Sequence[bytes]
                  ) -> bytes:
    """One atomic batch record: header+CRC, key/len-prefixed rows, commit
    footer whose CRC chains header and body (binding the payload to the
    seq it claims)."""
    body = b"".join(_ROW.pack(int(k), len(r)) + r
                    for k, r in zip(keys, rows))
    hdr = _HDR.pack(_BATCH_MAGIC, seq, len(keys), len(body))
    hdr += _HDR_CRC.pack(zlib.crc32(hdr))
    crc = zlib.crc32(body, zlib.crc32(hdr))
    return hdr + body + _FOOT.pack(_COMMIT_MAGIC, crc)


def _decode_batches(buf: bytes, path: str):
    """Yield ``(seq, [(key, row)...])`` for every committed batch in
    ``buf``; returns the offset where valid data ends (< len(buf) iff a
    torn tail was dropped).  Raises ``CorruptionError`` on any checksum
    failure over fully-present bytes (see the module docstring for the
    torn-vs-corrupt classification)."""
    out = []
    off, end = 0, len(buf)
    while off < end:
        if off + HEADER_BYTES > end:
            break                                    # torn header at tail
        hdr = buf[off:off + _HDR.size]
        magic, seq, n_rows, body_len = _HDR.unpack(hdr)
        (hcrc,) = _HDR_CRC.unpack_from(buf, off + _HDR.size)
        if magic != _BATCH_MAGIC or hcrc != zlib.crc32(hdr):
            raise CorruptionError(
                f"{path}: bad batch header at offset {off} "
                f"(magic={magic:#x})")
        total = HEADER_BYTES + body_len + FOOTER_BYTES
        if off + total > end:
            break                                    # torn body/footer
        body = buf[off + HEADER_BYTES:off + HEADER_BYTES + body_len]
        cmagic, crc = _FOOT.unpack_from(buf, off + HEADER_BYTES + body_len)
        want = zlib.crc32(body, zlib.crc32(buf[off:off + HEADER_BYTES]))
        if cmagic != _COMMIT_MAGIC or crc != want:
            raise CorruptionError(
                f"{path}: batch seq={seq} at offset {off} fails its "
                f"commit checksum")
        rows, roff = [], 0
        for _ in range(n_rows):
            key, rlen = _ROW.unpack_from(body, roff)
            roff += _ROW.size
            rows.append((key, body[roff:roff + rlen]))
            roff += rlen
        if roff != body_len:
            raise CorruptionError(
                f"{path}: batch seq={seq} at offset {off} row framing "
                f"does not cover its body ({roff} != {body_len})")
        out.append((seq, rows))
        off += total
    return out, off


_M64 = (1 << 64) - 1
_BLOOM_LN2 = 0.6931471805599453


def _bloom_mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized (uint64 arithmetic wraps mod 2^64,
    matching the masked scalar path in ``_bloom_may_contain``)."""
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _bloom_build(keys: Sequence[int], bits_per_key: int):
    """Build a double-hashed bloom filter over ``keys``: returns
    ``(n_hashes, bits)`` with ``bits`` a uint8 array.  Probe ``i`` tests
    bit ``(h1 + i*h2) mod n_bits`` — the classic Kirsch–Mitzenmacher
    scheme, so two mixes cover all ``n_hashes`` probes."""
    n_bits = max(64, len(keys) * int(bits_per_key))
    n_bits = (n_bits + 7) // 8 * 8
    k = max(1, int(round(bits_per_key * _BLOOM_LN2)))
    bits = np.zeros(n_bits // 8, np.uint8)
    if keys:
        ka = np.asarray(list(keys), np.int64).astype(np.uint64)
        h1 = _bloom_mix(ka + np.uint64(0x9E3779B97F4A7C15))
        h2 = _bloom_mix(ka ^ np.uint64(0x5851F42D4C957F2D)) | np.uint64(1)
        for i in range(k):
            idx = (h1 + np.uint64(i) * h2) % np.uint64(n_bits)
            np.bitwise_or.at(
                bits, (idx >> np.uint64(3)).astype(np.int64),
                np.left_shift(np.uint8(1),
                              (idx & np.uint64(7)).astype(np.uint8)))
    return k, bits


def _mix64(x: int) -> int:
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _bloom_may_contain(bits: np.ndarray, n_bits: int, n_hashes: int,
                       key: int) -> bool:
    """Scalar probe matching ``_bloom_build`` bit for bit (two's-complement
    key widening, 64-bit wrapping combine)."""
    x = key & _M64
    h1 = _mix64((x + 0x9E3779B97F4A7C15) & _M64)
    h2 = _mix64(x ^ 0x5851F42D4C957F2D) | 1
    for i in range(n_hashes):
        idx = ((h1 + i * h2) & _M64) % n_bits
        if not (int(bits[idx >> 3]) >> (idx & 7)) & 1:
            return False
    return True


class _TokenBucket:
    """Token-bucket throttle on background-compaction write bytes: the
    compactor takes ``nbytes`` of budget per chunk and sleeps off any
    deficit, so sustained compaction bandwidth converges to
    ``rate_bytes_per_s`` and foreground WAL fsyncs are never starved by a
    segment-write burst."""

    def __init__(self, rate_bytes_per_s: float,
                 burst_bytes: Optional[int] = None):
        self.rate = float(rate_bytes_per_s)
        if self.rate <= 0:
            raise ValueError("compact_rate_bytes_per_s must be > 0")
        self.burst = float(burst_bytes if burst_bytes is not None
                           else max(self.rate * 0.05, _COMPACT_CHUNK))
        self._tokens = self.burst
        self._t = time.perf_counter()

    def throttle(self, nbytes: int) -> float:
        """Charge ``nbytes``; sleep off any deficit.  Returns seconds
        slept (the ``compact_throttle_s`` counter)."""
        now = time.perf_counter()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now
        self._tokens -= float(nbytes)
        if self._tokens >= 0.0:
            return 0.0
        time.sleep(-self._tokens / self.rate)
        now2 = time.perf_counter()
        self._tokens = min(self.burst,
                           self._tokens + (now2 - self._t) * self.rate)
        self._t = now2
        return now2 - now


def _encode_index(entries, first_seq: int, last_seq: int,
                  bloom=None) -> bytes:
    """Sidecar segment index: CRC'd header, then one ``(min_key, max_key,
    offset, block_len)`` entry per non-empty block, then a body CRC
    chained on the header.  ``bloom=(n_hashes, bits)`` appends the
    optional CRC'd bloom trailer (absent when ``bloom_bits_per_key=0``,
    keeping the default sidecar byte-identical to the pre-bloom format)."""
    hdr = _IDX_HDR.pack(_IDX_MAGIC, len(entries), first_seq, last_seq)
    hdr += _HDR_CRC.pack(zlib.crc32(hdr))
    body = b"".join(_IDX_ENT.pack(*e) for e in entries)
    out = hdr + body + _HDR_CRC.pack(zlib.crc32(body, zlib.crc32(hdr)))
    if bloom is not None:
        n_hashes, bits = bloom
        bhdr = _BLM_HDR.pack(_BLM_MAGIC, int(n_hashes), len(bits) * 8)
        bhdr += _HDR_CRC.pack(zlib.crc32(bhdr))
        raw = bits.tobytes()
        out += bhdr + raw + _HDR_CRC.pack(zlib.crc32(raw, zlib.crc32(bhdr)))
    return out


def _decode_index(buf: bytes, path: str):
    """Parse a sidecar index (returns ``entries, first_seq, last_seq,
    bloom`` with ``bloom = (n_bits, n_hashes, bits) | None``); raises
    ``ValueError`` on any framing or checksum failure over the index *or*
    its bloom trailer (the caller falls back to the eager scan — the
    sidecar is derived data, so a bad one costs time, never
    correctness)."""
    hsz = _IDX_HDR.size + _HDR_CRC.size
    if len(buf) < hsz:
        raise ValueError(f"{path}: short index header")
    magic, nb, first_seq, last_seq = _IDX_HDR.unpack_from(buf, 0)
    (hcrc,) = _HDR_CRC.unpack_from(buf, _IDX_HDR.size)
    if magic != _IDX_MAGIC or hcrc != zlib.crc32(buf[:_IDX_HDR.size]):
        raise ValueError(f"{path}: bad index header")
    end = hsz + nb * _IDX_ENT.size
    if len(buf) < end + _HDR_CRC.size:
        raise ValueError(f"{path}: index length mismatch")
    body = buf[hsz:end]
    (crc,) = _HDR_CRC.unpack_from(buf, end)
    if crc != zlib.crc32(body, zlib.crc32(buf[:hsz])):
        raise ValueError(f"{path}: index body checksum failure")
    entries = [_IDX_ENT.unpack_from(body, i * _IDX_ENT.size)
               for i in range(nb)]
    bloom = None
    tail = buf[end + _HDR_CRC.size:]
    if tail:
        bhsz = _BLM_HDR.size + _HDR_CRC.size
        if len(tail) < bhsz:
            raise ValueError(f"{path}: short bloom trailer")
        bmagic, n_hashes, n_bits = _BLM_HDR.unpack_from(tail, 0)
        (bhcrc,) = _HDR_CRC.unpack_from(tail, _BLM_HDR.size)
        if bmagic != _BLM_MAGIC or bhcrc != zlib.crc32(tail[:_BLM_HDR.size]):
            raise ValueError(f"{path}: bad bloom trailer header")
        n_bytes = n_bits // 8
        if (n_hashes < 1 or n_bits <= 0 or n_bits % 8
                or len(tail) != bhsz + n_bytes + _HDR_CRC.size):
            raise ValueError(f"{path}: bloom trailer length mismatch")
        raw = tail[bhsz:bhsz + n_bytes]
        (bcrc,) = _HDR_CRC.unpack_from(tail, bhsz + n_bytes)
        if bcrc != zlib.crc32(raw, zlib.crc32(tail[:bhsz])):
            raise ValueError(f"{path}: bloom trailer checksum failure")
        bloom = (n_bits, n_hashes, np.frombuffer(raw, np.uint8))
    return entries, first_seq, last_seq, bloom


class DurableStore(KVStore):
    """Embedded WAL+memtable+compaction store, drop-in behind ``KVStore``.

    ``DurableStore(path)`` creates the directory (or recovers from it if it
    exists — segments first, then the seq-guarded WAL replay).  The modeled
    service-time machinery of the base class keeps running so modeled and
    measured IO can be reported side by side; the measured columns live on
    ``self.durable`` (see ``DurableCounters``) and are surfaced through
    ``measured()`` into ``SinkStats.snapshot()``.

    ``sync=True`` (default) fsyncs once per batch append — the group-commit
    contract.  ``sync=False`` is for tests/benchmarks that only need the
    byte path, not the durability guarantee.  Single-writer: exactly one
    thread may mutate a store at a time (the write-behind sink dedicates
    one flush worker per store, satisfying this by construction).  Under
    ``compaction="background"`` the store-internal compactor thread is the
    one sanctioned second mutator: the store mutex serializes its memtable
    snapshot and WAL swap against the writer and against cold-read block
    faulting, and everything between those two critical sections runs
    concurrently with foreground traffic.
    """

    def __init__(self, path: str, *, model: Optional[StorageModel] = None,
                 seed: int = 0, fileops: Optional[FileOps] = None,
                 compact_threshold_bytes: int = 1 << 20,
                 sync: bool = True, recover: bool = True,
                 seg_block_rows: int = 256, lazy_recovery: bool = False,
                 compaction: str = "inline",
                 compact_rate_bytes_per_s: Optional[float] = None,
                 bloom_bits_per_key: int = 0):
        super().__init__(model=model, seed=seed)
        self.path = str(path)
        self.fops = fileops or FileOps()
        self.compact_threshold_bytes = int(compact_threshold_bytes)
        self.sync = bool(sync)
        self.seg_block_rows = int(seg_block_rows)
        if self.seg_block_rows < 1:
            raise ValueError("seg_block_rows must be >= 1")
        if compaction not in COMPACTION:
            raise ValueError(f"compaction must be one of {COMPACTION}, "
                             f"got {compaction!r}")
        self.compaction = compaction
        self.bloom_bits_per_key = int(bloom_bits_per_key)
        if self.bloom_bits_per_key < 0:
            raise ValueError("bloom_bits_per_key must be >= 0")
        self._rate = (_TokenBucket(compact_rate_bytes_per_s)
                      if compact_rate_bytes_per_s else None)
        self.lazy_recovery = bool(lazy_recovery)
        self.durable = DurableCounters()
        self._next_seq = 1
        self._applied_seq = 0
        self._wal_size = 0
        self._seg_size_bytes = 0    # registered segment length (stat-only)
        self._closed = False
        # store mutex: memtable/WAL mutation and the compactor's snapshot
        # + swap critical sections (RLock: the writer path is reentrant)
        self._mtx = threading.RLock()
        # one compaction at a time (explicit compact() vs the compactor)
        self._compact_mu = threading.Lock()
        self._bg_exc: Optional[BaseException] = None
        self._bg_stop = False
        self._compact_evt: Optional[threading.Event] = None
        self._bg_thread: Optional[threading.Thread] = None
        # lazy-recovery read path: the newest segment's sidecar index
        # (None = fully materialized; every row is in the memtable)
        self._seg_file: Optional[str] = None
        self._seg_index: Optional[List[Tuple[int, int, int, int]]] = None
        self._seg_mins: List[int] = []
        self._seg_loaded: set = set()
        self._seg_bloom: Optional[Tuple[int, int, np.ndarray]] = None
        os.makedirs(self.path, exist_ok=True)
        self._lock_fd = self._lock_dir()
        try:
            if recover:
                t0 = time.perf_counter()
                self._recover()
                self.durable.recovery_s = time.perf_counter() - t0
        except BaseException:
            os.close(self._lock_fd)
            raise
        self._wal_f = self.fops.open(self._wal_path(), "ab")
        self._wal_size = os.path.getsize(self._wal_path())
        if self.compaction == "background":
            self._compact_evt = threading.Event()
            self._bg_thread = threading.Thread(
                target=self._bg_loop, daemon=True,
                name=f"compact:{os.path.basename(self.path)}")
            self._bg_thread.start()
            if self._wal_size >= self.compact_threshold_bytes:
                self._compact_evt.set()

    def _lock_dir(self) -> int:
        """Take the directory's single-writer lock: an exclusive POSIX
        record lock on ``LOCK``, held until ``close`` (or the process's
        end, a crash included).  Another process that opens the directory
        meanwhile gets ``PartitionLockedError``; this process may open it
        again (a test's reopen after an abandoned handle)."""
        fd = os.open(os.path.join(self.path, LOCK_NAME),
                     os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.lockf(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            os.close(fd)
            raise PartitionLockedError(
                f"{self.path} is open in another process: a store has "
                f"one writer") from e
        return fd

    # ------------------------------------------------------------- paths
    def _wal_path(self) -> str:
        return os.path.join(self.path, WAL_NAME)

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.path, f"seg-{seq:012d}{SEG_SUFFIX}")

    @staticmethod
    def _idx_path(seg_path: str) -> str:
        return seg_path[:-len(SEG_SUFFIX)] + IDX_SUFFIX

    def _seg_files(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.path):
            if name.startswith("seg-") and name.endswith(SEG_SUFFIX):
                out.append((int(name[4:-len(SEG_SUFFIX)]),
                            os.path.join(self.path, name)))
        return sorted(out)

    # ---------------------------------------------------------- recovery
    def _recover(self) -> None:
        """Segments (ascending seq), then the WAL, batches seq-guarded.

        A ``.tmp`` segment is an unfinished compaction (crash before the
        atomic rename) and is discarded.  A torn WAL tail is dropped and
        the file repaired by truncation; corruption raises.

        ``lazy_recovery=True``: if the newest segment has a valid sidecar
        index, the segment is *not* read — its key ranges are registered
        for on-demand block faulting and only the WAL replays.  Any
        problem with the sidecar (missing, stale, corrupt) falls back to
        this eager path (``index_fallbacks``)."""
        d = self.durable
        for name in os.listdir(self.path):
            if name.endswith(".tmp"):
                os.remove(os.path.join(self.path, name))
        segs = self._seg_files()
        lazy_ok = False
        if self.lazy_recovery and segs:
            # the newest segment is a full memtable snapshot, so older
            # segments (a crash-window leftover) are subsumed by it
            lazy_ok = self._open_seg_index(*segs[-1])
            if not lazy_ok:
                d.index_fallbacks += 1
        if not lazy_ok:
            for seq, seg in segs:
                with self.fops.open(seg, "rb") as f:
                    buf = f.read()
                batches, valid = _decode_batches(buf, seg)
                if valid != len(buf):
                    # a published (renamed) segment was written and fsynced
                    # in full before the rename — a short one is corruption
                    raise CorruptionError(f"{seg}: truncated segment file")
                for bseq, rows in batches:
                    self._apply(bseq, rows, recovered=True)
        if segs:
            self._seg_size_bytes = sum(
                os.path.getsize(p) for _, p in segs)
        wal = self._wal_path()
        if os.path.exists(wal):
            with self.fops.open(wal, "rb") as f:
                buf = f.read()
            batches, valid = _decode_batches(buf, wal)
            for bseq, rows in batches:
                self._apply(bseq, rows, recovered=True)
            if valid != len(buf):
                d.torn_tails += 1
                d.torn_bytes_dropped += len(buf) - valid
                with self.fops.open(wal, "r+b") as f:
                    f.truncate(valid)

    def _apply(self, seq: int, rows, recovered: bool = False) -> None:
        d = self.durable
        if seq <= self._applied_seq:
            if recovered:
                d.stale_batches_skipped += 1
            return
        for key, raw in rows:
            self.data[int(key)] = raw
        self._applied_seq = seq
        self._next_seq = max(self._next_seq, seq + 1)
        if recovered:
            d.recovered_batches += 1

    # ------------------------------------------- sparse-index read path
    def _open_seg_index(self, seq0: int, seg: str) -> bool:
        """Register ``seg`` for lazy block faulting via its sidecar.
        Returns False (caller falls back to the eager scan) unless the
        sidecar exists, parses, matches the segment's base seq, and its
        entries fit the file with non-decreasing key ranges."""
        ipath = self._idx_path(seg)
        try:
            with self.fops.open(ipath, "rb") as f:
                buf = f.read()
            entries, first_seq, last_seq, bloom = _decode_index(buf, ipath)
        except (OSError, ValueError):
            return False
        if first_seq != seq0 or last_seq < first_seq:
            return False
        size = os.path.getsize(seg)
        mins = [e[0] for e in entries]
        if (any(off + ln > size for _, _, off, ln in entries)
                or any(a > b for a, b in zip(mins, mins[1:]))
                or any(mn > mx for mn, mx, _, _ in entries)):
            return False
        self._seg_file, self._seg_index, self._seg_mins = seg, entries, mins
        self._seg_loaded = set()
        self._seg_bloom = bloom
        self._seg_size_bytes = size
        self._applied_seq = last_seq
        self._next_seq = max(self._next_seq, last_seq + 1)
        return True

    def _seg_probe(self, key: int) -> None:
        """Cold lookup: the bloom filter (when the sidecar carries one)
        answers definite-absents with zero I/O even *inside* a block's key
        range; then binary-search the block whose min/max fence could hold
        ``key`` and fault it into the memtable."""
        d = self.durable
        d.seg_probes += 1
        bloom_pass = False
        if self._seg_bloom is not None:
            d.bloom_probes += 1
            n_bits, n_hashes, bits = self._seg_bloom
            if not _bloom_may_contain(bits, n_bits, n_hashes, key):
                d.bloom_skips += 1
                return
            bloom_pass = True
        pos = bisect.bisect_right(self._seg_mins, key) - 1
        if pos < 0 or key > self._seg_index[pos][1]:
            d.seg_blocks_skipped += 1
            if bloom_pass:
                d.bloom_false_positives += 1
            return
        if pos not in self._seg_loaded:
            self._load_block(pos)
        if key in self.data:
            d.seg_probe_hits += 1
        elif bloom_pass:
            d.bloom_false_positives += 1

    def _load_block(self, pos: int) -> None:
        """Read one indexed block and fold its rows into the memtable.
        ``setdefault``: a WAL-replayed (or newly written) row carries a
        higher seq than any segment row, so the memtable always wins."""
        _, _, off, ln = self._seg_index[pos]
        d = self.durable
        with self.fops.open(self._seg_file, "rb") as f:
            f.seek(off)
            buf = f.read(ln)
        batches, valid = _decode_batches(buf, self._seg_file)
        if valid != ln or len(batches) != 1:
            raise CorruptionError(
                f"{self._seg_file}: indexed block at offset {off} does "
                f"not frame one batch record")
        d.seg_blocks_read += 1
        d.seg_bytes_read += ln
        for k, raw in batches[0][1]:
            self.data.setdefault(int(k), raw)
        self._seg_loaded.add(pos)

    def _materialize_segment(self) -> None:
        """Fault in every remaining block (full-scan operations and
        compaction need the complete memtable), then drop the index."""
        if self._seg_index is None:
            return
        for pos in range(len(self._seg_index)):
            if pos not in self._seg_loaded:
                self._load_block(pos)
        self._seg_file = None
        self._seg_index = None
        self._seg_mins = []
        self._seg_loaded = set()
        self._seg_bloom = None

    # -------------------------------------------------------------- reads
    def get(self, key: int) -> Optional[bytes]:
        if self._seg_index is not None and int(key) not in self.data:
            with self._mtx:
                if self._seg_index is not None:
                    self._seg_probe(int(key))
        return super().get(key)

    def multi_get(self, keys) -> List[Optional[bytes]]:
        if self._seg_index is not None:
            with self._mtx:
                if self._seg_index is not None:
                    for k in np.asarray(keys).reshape(-1).tolist():
                        if int(k) not in self.data:
                            self._seg_probe(int(k))
        return super().multi_get(keys)

    def keys(self) -> Tuple[int, ...]:
        with self._mtx:
            self._materialize_segment()
        return super().keys()

    # ------------------------------------------------------------ writes
    def _append_batch(self, keys, rows) -> None:
        """Failure-atomic WAL append: either the whole batch is on the log
        (and fsynced, under ``sync=True``) or the file is restored to its
        pre-batch length — so a transient write error can simply be
        retried by the caller (the sink's backoff loop) without leaving a
        torn record mid-file."""
        if self._closed:
            raise RuntimeError("write on a closed DurableStore")
        self._check_bg()
        d = self.durable
        with self._mtx:
            seq = self._next_seq
            buf = _encode_batch(seq, keys, rows)
            pos = self._wal_size
            t0 = time.perf_counter()
            try:
                self._wal_f.write(buf)
                self._wal_f.flush()
            except OSError:
                d.io_write_s += time.perf_counter() - t0
                try:    # restore the pre-batch length: keep the log clean
                    self._wal_f.truncate(pos)
                    self._wal_f.seek(pos)
                except OSError:
                    pass   # a kill here leaves a torn tail — recovery drops
                raise
            d.io_write_s += time.perf_counter() - t0
            if self.sync:
                t0 = time.perf_counter()
                self.fops.fsync(self._wal_f)
                d.io_sync_s += time.perf_counter() - t0
                d.fsyncs += 1
            self._wal_size = pos + len(buf)
            d.wal_bytes += len(buf)
            d.batches += 1
            self._next_seq = seq + 1
            self._apply(seq, list(zip(map(int,
                                          np.asarray(keys).reshape(-1)),
                                      rows)))
            trigger = self._wal_size >= self.compact_threshold_bytes
        if trigger:
            # zero-read trigger check: both byte totals are counters
            if self._compact_evt is not None:
                self._compact_evt.set()
            else:
                t0 = time.perf_counter()
                self.compact()
                d.compaction_stall_s += time.perf_counter() - t0

    @staticmethod
    def _as_bytes(rows) -> List[bytes]:
        return [r.tobytes() if isinstance(r, np.ndarray) else bytes(r)
                for r in rows]

    def put(self, key: int, raw: bytes) -> None:
        raw = bytes(raw)
        self._append_batch([int(key)], [raw])
        # modeled accounting + memtable write ride the base implementation
        super().put(int(key), raw)

    def multi_put(self, keys, rows) -> None:
        """One flush group's batch: a single atomic WAL record, a single
        group-commit fsync."""
        rows_b = self._as_bytes(rows)
        keys = np.asarray(keys).reshape(-1)
        self._append_batch(keys, rows_b)
        super().multi_put(keys, rows_b)

    # -------------------------------------------------------- compaction
    def compact(self) -> None:
        """Write the memtable as one sorted *blocked* segment plus its
        sidecar index (and bloom trailer, under ``bloom_bits_per_key>0``),
        drop the covered WAL prefix, remove superseded segments.  Every
        step is individually crash-safe (see the module docstring for the
        ordering argument); the sidecar is written after the segment it
        describes, so a crash between the two renames leaves a segment
        without an index — an ``index_fallbacks`` full scan, never a
        wrong answer.  Serialized against the background compactor; safe
        to call explicitly in either mode."""
        self._check_bg()
        with self._compact_mu:
            self._compact_impl()

    def _compact_impl(self) -> None:
        d = self.durable
        with self._mtx:
            if self._wal_size == 0:
                # nothing new since the last compaction (or a fresh empty
                # store): the size decision takes two counter reads and no
                # segment materialization — the satellite fix for the old
                # always-materialize behavior
                d.compactions_skipped += 1
                return
            # a lazily-opened memtable is partial; the snapshot must be
            # full before it can subsume the on-disk segment
            self._materialize_segment()
            snap = dict(self.data)
            ks = sorted(snap)
            br = self.seg_block_rows
            n_chunks = max(1, -(-len(ks) // br))
            # reserve the segment's seq block *now*: appends that land
            # while the segment builds get seqs above last_seq, so the
            # recovery seq guard never drops them
            seq0 = self._next_seq
            last_seq = seq0 + n_chunks - 1
            self._next_seq = last_seq + 1
            wal_covered = self._wal_size
            old_segs = [p for _, p in self._seg_files()]
        chunks = [ks[i:i + br] for i in range(0, len(ks), br)] or [[]]
        parts: List[bytes] = []
        entries: List[Tuple[int, int, int, int]] = []
        off = 0
        for j, ck in enumerate(chunks):
            blk = _encode_batch(seq0 + j, ck, [snap[k] for k in ck])
            if ck:
                entries.append((ck[0], ck[-1], off, len(blk)))
            parts.append(blk)
            off += len(blk)
        buf = b"".join(parts)
        seg = self._seg_path(seq0)
        tmp = seg + ".tmp"
        t0 = time.perf_counter()
        throttled = 0.0
        with self.fops.open(tmp, "wb") as f:
            if self._rate is None:
                f.write(buf)
            else:
                for i in range(0, len(buf), _COMPACT_CHUNK):
                    chunk = buf[i:i + _COMPACT_CHUNK]
                    throttled += self._rate.throttle(len(chunk))
                    f.write(chunk)
            self.fops.fsync(f)
        d.fsyncs += 1
        self.fops.replace(tmp, seg)
        bloom = None
        if self.bloom_bits_per_key > 0:
            bloom = _bloom_build(ks, self.bloom_bits_per_key)
        ibuf = _encode_index(entries, seq0, last_seq, bloom)
        itmp = self._idx_path(seg) + ".tmp"
        with self.fops.open(itmp, "wb") as f:
            f.write(ibuf)
            self.fops.fsync(f)
        d.fsyncs += 1
        self.fops.replace(itmp, self._idx_path(seg))
        self.fops.fsync_dir(self.path)
        d.fsyncs += 1
        # segment durable: the covered WAL prefix is now stale (seq guard)
        with self._mtx:
            if self._wal_size == wal_covered:
                # no appends landed during the build: plain truncate —
                # byte-identical to the historic inline behavior
                self._wal_f.truncate(0)
                self._wal_f.seek(0)
                self.fops.fsync(self._wal_f)
                d.fsyncs += 1
                self._wal_size = 0
            else:
                # rewrite the uncovered tail into a fresh log and swap it
                # in atomically; a crash anywhere in between leaves either
                # the old WAL (covered prefix goes stale via the seq
                # guard) or the new one — never a torn log
                wal = self._wal_path()
                with self.fops.open(wal, "rb") as f:
                    f.seek(wal_covered)
                    tail = f.read()
                wtmp = wal + ".tmp"
                with self.fops.open(wtmp, "wb") as f:
                    f.write(tail)
                    self.fops.fsync(f)
                d.fsyncs += 1
                self.fops.replace(wtmp, wal)
                old_f = self._wal_f
                self._wal_f = self.fops.open(wal, "ab")
                old_f.close()
                self.fops.fsync_dir(self.path)
                d.fsyncs += 1
                self._wal_size = len(tail)
                d.wal_tail_rewrites += 1
            self._applied_seq = max(self._applied_seq, last_seq)
            self._seg_size_bytes = len(buf)
        d.io_write_s += time.perf_counter() - t0 - throttled
        d.compact_throttle_s += throttled
        for p in old_segs:
            self.fops.remove(p)
            old_idx = self._idx_path(p)
            if os.path.exists(old_idx):
                self.fops.remove(old_idx)
        d.seg_bytes += len(buf)
        d.seg_index_bytes += len(ibuf)
        d.compactions += 1

    def _bg_loop(self) -> None:
        """Per-store compactor: parked on the trigger event, drains until
        the WAL is back under threshold, exits on stop or on the first
        error (which poisons the store — ``_check_bg``)."""
        evt = self._compact_evt
        while True:
            evt.wait()
            evt.clear()
            if self._bg_stop:
                return
            try:
                while (not self._bg_stop and
                       self._wal_size >= self.compact_threshold_bytes):
                    with self._compact_mu:
                        self._compact_impl()
            except BaseException as e:       # surfaced on the next write
                self._bg_exc = e
                return

    def _check_bg(self) -> None:
        """Poisoned-store surfacing: a background-compaction failure
        raises here — on the next write, explicit ``compact()`` or
        ``close()`` (and through the sink's retry/poison machinery, on
        the next ``submit()``/``flush()``/``close()``)."""
        exc = self._bg_exc
        if exc is not None:
            self._bg_exc = None
            raise RuntimeError(
                f"{self.path}: background compaction failed") from exc

    def wait_for_compaction(self, timeout_s: float = 60.0) -> None:
        """Test/bench barrier: block until the background compactor has
        drained below the trigger threshold (no-op under inline mode);
        surfaces a compactor error like ``_check_bg``."""
        if self._bg_thread is None:
            return
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self._check_bg()
            if (not self._compact_evt.is_set()
                    and not self._compact_mu.locked()
                    and self._wal_size < self.compact_threshold_bytes):
                return
            time.sleep(0.001)
        raise TimeoutError(f"{self.path}: background compaction did not "
                           f"drain within {timeout_s}s")

    def storage_bytes(self) -> dict:
        """Zero-disk-read size accounting: WAL length and registered
        segment length come from counters (maintained at append,
        compaction and recovery), never from reading data files — the
        background trigger check and the bench read these."""
        return {"wal_bytes": self._wal_size,
                "seg_bytes": self._seg_size_bytes}

    # --------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._bg_thread is not None:
            # let an in-flight compaction finish, then stop the compactor
            self._bg_stop = True
            self._compact_evt.set()
            self._bg_thread.join()
        try:
            if self.sync:
                with self._mtx:
                    self.fops.fsync(self._wal_f)
                    self.durable.fsyncs += 1
        finally:
            self._wal_f.close()
            os.close(self._lock_fd)     # releases the directory's lock
        self._check_bg()

    def __enter__(self) -> "DurableStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------ observability
    def measured(self) -> dict:
        """Measured durability counters (merged into sink snapshots)."""
        return self.durable.snapshot()

    def measured_waf(self) -> float:
        """Physical bytes (WAL appends + segment writes) per logical byte
        ingested — the measured counterpart of the base class's modeled
        ``waf()``."""
        d = self.durable
        logical = max(self.counters.bytes_written, 1)
        return (d.wal_bytes + d.seg_bytes) / logical


def open_partition_stores(path: str, n_partitions: int, *,
                          owned: Optional[Sequence[int]] = None,
                          model: Optional[StorageModel] = None,
                          seed: int = 0, **kw) -> List[DurableStore]:
    """Open (or create) one ``DurableStore`` per partition under ``path``
    (``part-0000/`` ... layout-aligned with the sink's ``partition_fn``).
    Reopening the same directory recovers every partition from its
    WAL+segments — the restart path of ``ShardedFeatureEngine.
    hydrate_from_dir`` and ``serving.pipeline.run_restart_demo``.

    ``owned``: open only these partitions (in this order) — a rank of the
    sharded engine opens its own and never another rank's; each store
    holds its directory's lock (``PartitionLockedError`` if another
    process has it open)."""
    os.makedirs(path, exist_ok=True)
    parts = range(int(n_partitions)) if owned is None else owned
    out: List[DurableStore] = []
    try:
        for i in parts:
            if not 0 <= int(i) < int(n_partitions):
                raise ValueError(f"partition {i} is outside "
                                 f"{n_partitions} partitions")
            out.append(DurableStore(os.path.join(path, f"part-{int(i):04d}"),
                                    model=model, seed=seed + int(i), **kw))
    except BaseException:
        for s in out:
            s.close()
        raise
    return out
