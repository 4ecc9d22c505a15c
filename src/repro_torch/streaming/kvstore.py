"""Durable KV-store worker model with real SerDe and an LSM cost model.

The paper's worker (§5.3) is a JVM process over embedded RocksDB; its costs
are (a) serialization/deserialization of profile rows, (b) storage IOPS,
(c) LSM write amplification from compaction.  On this CPU container we keep
(a) *real* — profile rows are packed to/from bytes on every access — and
model (b)/(c) explicitly:

  * storage service time: get ~ Gamma(k, theta_r), put ~ Gamma(k, theta_w),
    defaults shaped like SSD EBS latencies (~100us reads / ~300us writes);
    batched ops (``multi_get``/``multi_put``) pay one such seek-shaped draw
    plus a small per-row sequential cost (``StorageModel.batch_row_us``) —
    the amortization a write-behind sink exists to exploit;
  * write amplification: leveled-compaction model following Dayan et al. —
    WAF ~= 1 (WAL+L0) + sum over levels of the size-ratio amortization, with
    level count driven by total ingested bytes, so lower ingest rates sit
    below compaction thresholds exactly as Table 3 observes.

The store counts every op and byte, which is what §Dry-run / Table 3
benchmarks read out.

SerDe exists in two equivalent forms: the scalar ``pack``/``unpack`` used
by the per-event worker, and the vectorized ``pack_rows``/``unpack_rows``
used by the write-behind sink (``streaming/persistence.py``) over ``[N]``
numpy columns.  Both produce the identical byte layout — the vectorized
form is a numpy structured-dtype view of the same packed struct — and the
test suite pins them bit-identical.
"""
from __future__ import annotations

import dataclasses
import struct
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PROFILE_MAGIC = 0x5250      # 'RP'


@dataclasses.dataclass
class StorageModel:
    """Service-time + LSM model (modeled, not measured — documented).

    ``sleep_io=False`` (default) only *accounts* the drawn service times
    (``StoreCounters.modeled_io_s``) — total modeled cost is observable
    but no wall-clock elapses, which is right for throughput benchmarks
    of the compute plane.  ``sleep_io=True`` makes each store op actually
    sleep its drawn service time on the calling thread: the store then
    *behaves* like the device it models (ops have latency, a partition's
    single worker serializes them), which is what latency-hiding
    experiments need — an accounted-but-instant store would erase the
    very stalls a pipelined driver exists to hide.
    """
    read_us: float = 100.0
    write_us: float = 300.0
    gamma_shape: float = 4.0
    batch_row_us: float = 5.0       # marginal per-row cost inside one batch op
    memtable_bytes: int = 1 << 16   # 64 KiB flush unit (CPU-scale streams)
    size_ratio: int = 10            # leveled-compaction fanout T
    bytes_per_entry: int = 128
    sleep_io: bool = False          # modeled latencies actually elapse

    def service_time_s(self, rng: np.random.Generator, write: bool) -> float:
        mean = self.write_us if write else self.read_us
        return rng.gamma(self.gamma_shape, mean / self.gamma_shape) * 1e-6

    def batch_service_time_s(self, rng: np.random.Generator, write: bool,
                             n_rows: int) -> float:
        """One batched op: a single seek-shaped draw + sequential row cost.

        Models what an embedded store's MultiGet / WriteBatch achieves: the
        fixed per-op latency is paid once, each additional row only adds
        ``batch_row_us`` of sequential work.
        """
        if n_rows <= 0:
            return 0.0
        return (self.service_time_s(rng, write)
                + (n_rows - 1) * self.batch_row_us * 1e-6)

    def waf(self, bytes_ingested: int) -> float:
        """Leveled-compaction write amplification at this ingest volume.

        Each level rewrite costs ~T/2 per level on average; number of levels
        grows with log_T(total / memtable).  Matches the paper's observed
        2.6 (full ingest) -> 1.7 (heavy thinning) range.
        """
        if bytes_ingested <= self.memtable_bytes:
            return 1.0
        levels = np.log(bytes_ingested / self.memtable_bytes) \
            / np.log(self.size_ratio)
        # WAL + memtable flush = 1; each populated level adds amortized
        # (T/2) / T = 0.5 rewrite share under leveling.
        return float(1.0 + 0.5 * min(levels, 4.0))


class SerDe:
    """Binary profile-row codec (the paper's SerDe bottleneck, made real).

    Layout: magic u16, n_taus u16, last_t f64, v_f f64, then n_taus * 3 f32
    aggregates, then v_full f64, last_t_full f64.  ``pack_rows`` /
    ``unpack_rows`` are the vectorized forms over ``[N]`` columns; they are
    byte-identical to the scalar forms (structured-dtype view of the same
    packed layout, no alignment padding).
    """

    def __init__(self, n_taus: int):
        self.n_taus = n_taus
        self._head = struct.Struct("<HHdd")
        self._tail = struct.Struct("<dd")
        self._row_dtype = np.dtype([
            ("magic", "<u2"), ("n", "<u2"), ("last_t", "<f8"), ("v_f", "<f8"),
            ("agg", "<f4", (n_taus, 3)),
            ("v_full", "<f8"), ("last_t_full", "<f8")])
        assert self._row_dtype.itemsize == self.row_bytes()  # packed layout

    def row_bytes(self) -> int:
        return self._head.size + self.n_taus * 3 * 4 + self._tail.size

    @staticmethod
    def _ctx(key=None, partition=None) -> str:
        """Error-message suffix naming where a bad row came from, so a
        corrupt byte string is attributable without a debugger."""
        out = ""
        if key is not None:
            out += f" for key {int(key)}"
        if partition is not None:
            out += f" in partition {int(partition)}"
        return out

    def pack(self, last_t: float, v_f: float, agg: np.ndarray,
             v_full: float, last_t_full: float) -> bytes:
        return (self._head.pack(PROFILE_MAGIC, self.n_taus, last_t, v_f)
                + agg.astype("<f4").tobytes()
                + self._tail.pack(v_full, last_t_full))

    def unpack(self, raw: bytes, *, key=None, partition=None):
        if len(raw) < self.row_bytes():
            raise ValueError(
                f"truncated profile row{self._ctx(key, partition)}: "
                f"{len(raw)} < {self.row_bytes()} bytes")
        magic, n, last_t, v_f = self._head.unpack_from(raw, 0)
        if magic != PROFILE_MAGIC or n != self.n_taus:
            # explicit (not `assert`): corruption must surface under -O too
            raise ValueError(
                f"corrupt profile row{self._ctx(key, partition)}: "
                f"magic={magic:#x} n_taus={n} "
                f"(want {PROFILE_MAGIC:#x}/{self.n_taus})")
        off = self._head.size
        agg = np.frombuffer(raw, "<f4", count=n * 3, offset=off
                            ).reshape(n, 3).copy()
        v_full, last_t_full = self._tail.unpack_from(raw, off + n * 3 * 4)
        return last_t, v_f, agg, v_full, last_t_full

    # ------------------------------------------------------ vectorized form
    def pack_rows(self, last_t, v_f, agg, v_full, last_t_full) -> np.ndarray:
        """Pack ``[N]`` row columns into a ``[N, row_bytes] uint8`` matrix.

        ``agg`` is ``[N, n_taus, 3]``; scalar columns are ``[N]``.  Row ``i``
        of the result is byte-identical to ``pack(last_t[i], ...)``.
        """
        n = np.shape(last_t)[0]
        out = np.empty(n, self._row_dtype)
        out["magic"] = PROFILE_MAGIC
        out["n"] = self.n_taus
        out["last_t"] = np.asarray(last_t, np.float64)
        out["v_f"] = np.asarray(v_f, np.float64)
        out["agg"] = np.asarray(agg, np.float32).reshape(n, self.n_taus, 3)
        out["v_full"] = np.asarray(v_full, np.float64)
        out["last_t_full"] = np.asarray(last_t_full, np.float64)
        return out.view(np.uint8).reshape(n, self.row_bytes())

    def unpack_rows(self, raws: Sequence[bytes], *, keys=None,
                    partition=None):
        """Inverse of ``pack_rows`` over a sequence of row byte strings.

        Returns ``(last_t, v_f, agg, v_full, last_t_full)`` numpy columns
        (``agg`` is ``[N, n_taus, 3] float32``).  Every entry must be
        exactly one packed row: an empty byte string, an off-by-one row or
        a non-multiple blob raises ``ValueError`` — joining first and
        checking only the total length would let a dropped row and a
        padded row cancel out.  ``keys``/``partition`` (optional, aligned
        with ``raws``) put the owning key and partition in the message,
        like the scalar ``unpack``.
        """
        rb = self.row_bytes()
        for i, r in enumerate(raws):
            if len(r) != rb:
                key = keys[i] if keys is not None else None
                raise ValueError(
                    f"truncated profile row at index "
                    f"{i}{self._ctx(key, partition)}: {len(r)} bytes "
                    f"(want exactly row_bytes={rb})")
        buf = b"".join(raws)
        arr = np.frombuffer(buf, self._row_dtype)
        if arr.size and not (np.all(arr["magic"] == PROFILE_MAGIC)
                             and np.all(arr["n"] == self.n_taus)):
            bad = int(np.argmax((arr["magic"] != PROFILE_MAGIC)
                                | (arr["n"] != self.n_taus)))
            key = keys[bad] if keys is not None else None
            raise ValueError(
                f"corrupt profile row at index "
                f"{bad}{self._ctx(key, partition)}: "
                f"magic={int(arr['magic'][bad]):#x} n_taus={int(arr['n'][bad])} "
                f"(want {PROFILE_MAGIC:#x}/{self.n_taus})")
        return (arr["last_t"].copy(), arr["v_f"].copy(), arr["agg"].copy(),
                arr["v_full"].copy(), arr["last_t_full"].copy())


@dataclasses.dataclass
class StoreCounters:
    gets: int = 0
    puts: int = 0
    batch_gets: int = 0
    batch_puts: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    serde_s: float = 0.0
    modeled_io_s: float = 0.0
    # read/write split of modeled_io_s: the read path (hydration,
    # recovery) must be observable separately from the write path
    # (modeled_io_s == modeled_read_s + modeled_write_s).
    modeled_read_s: float = 0.0
    modeled_write_s: float = 0.0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class KVStore:
    """One worker's embedded store (dict-backed, byte-valued)."""

    def __init__(self, model: Optional[StorageModel] = None, seed: int = 0):
        self.data: Dict[int, bytes] = {}
        self.model = model or StorageModel()
        self.rng = np.random.default_rng(seed)
        self.counters = StoreCounters()

    def _account_io(self, seconds: float, write: bool) -> None:
        self.counters.modeled_io_s += seconds
        if write:
            self.counters.modeled_write_s += seconds
        else:
            self.counters.modeled_read_s += seconds
        if self.model.sleep_io and seconds > 0.0:
            time.sleep(seconds)

    def get(self, key: int) -> Optional[bytes]:
        self.counters.gets += 1
        raw = self.data.get(key)
        if raw is not None:
            self.counters.bytes_read += len(raw)
        self._account_io(self.model.service_time_s(self.rng, write=False),
                         write=False)
        return raw

    def put(self, key: int, raw: bytes) -> None:
        self.counters.puts += 1
        self.counters.bytes_written += len(raw)
        self._account_io(self.model.service_time_s(self.rng, write=True),
                         write=True)
        self.data[key] = raw

    # ------------------------------------------------------- batched ops
    def multi_get(self, keys: Iterable[int]) -> List[Optional[bytes]]:
        """Batched get: one seek draw + per-row sequential cost (MultiGet)."""
        keys = (keys.tolist() if isinstance(keys, np.ndarray)
                else [int(k) for k in keys])
        out = list(map(self.data.get, keys))
        self.counters.bytes_read += sum(len(r) for r in out if r is not None)
        self.counters.gets += len(keys)
        self.counters.batch_gets += 1
        self._account_io(self.model.batch_service_time_s(
            self.rng, write=False, n_rows=len(keys)), write=False)
        return out

    def multi_put(self, keys, rows) -> None:
        """Batched put (WriteBatch): ``rows`` is a ``[N, row_bytes]`` uint8
        matrix (``SerDe.pack_rows`` output) or a sequence of byte strings."""
        keys = np.asarray(keys)
        n = len(keys)
        if isinstance(rows, np.ndarray) and rows.ndim == 2:
            # matrix fast path: one contiguous serialization, then slice —
            # a per-row ``tobytes()`` loop costs ~3x more on the store
            # worker thread, which the flush path serializes behind
            rb = rows.shape[1]
            buf = rows.tobytes()
            self.data.update(zip(
                keys.tolist(),
                (buf[i * rb:(i + 1) * rb] for i in range(n))))
            self.counters.bytes_written += n * rb
        else:
            for i in range(n):
                raw = rows[i].tobytes() if isinstance(rows[i], np.ndarray) \
                    else bytes(rows[i])
                self.counters.bytes_written += len(raw)
                self.data[int(keys[i])] = raw
        self.counters.puts += n
        self.counters.batch_puts += 1
        self._account_io(self.model.batch_service_time_s(
            self.rng, write=True, n_rows=n), write=True)

    def keys(self) -> Tuple[int, ...]:
        """Stored keys in deterministic (sorted) order — the recovery scan."""
        return tuple(sorted(self.data))

    def waf(self) -> float:
        return self.model.waf(self.counters.bytes_written)

    def memtable_bytes(self) -> int:
        """Resident payload bytes of the in-memory table (a host-RAM
        scan, O(rows)).  Distinct from ``DurableStore.storage_bytes()``,
        which reports *on-disk* WAL/segment lengths from counters with
        zero reads — the compaction trigger uses that one; this one is
        for memory-watermark reporting."""
        return sum(len(r) for r in self.data.values())

    def measured(self) -> dict:
        """Measured durability counters.  The modeled in-memory store has
        none (empty dict); ``streaming.durable.DurableStore`` overrides
        this with real fsync/byte/recovery numbers — including the
        storage-plane columns (``io_write_s``/``io_sync_s``, bloom
        ``bloom_probes``/``bloom_skips``/``bloom_false_positives``,
        ``compaction_stall_s``/``compact_throttle_s``) — which the sink's
        ``snapshot()`` aggregates next to the modeled columns (and, for
        the write/sync split, per partition)."""
        return {}


def partition_of(key: int, n_partitions: int) -> int:
    """Deterministic key routing, aligned with the sharded engine's block
    layout (``features/engine.py``: shard ``s`` owns ``key % n_shards == s``)
    so per-event workers and the write-behind sink land a key on the same
    partition as the shard that computes it."""
    return int(key) % n_partitions
