"""Host-RAM L2 tier for the write-behind sink (``HostL2Cache``).

The counterpart of ``repro.streaming.residency``'s ``HostL2Cache``, copied
unchanged: packed SerDe rows (``kvstore.SerDe.pack_rows`` bytes, no
unpack/repack round-trip) keyed by global entity id, sitting between the
device state and the durable store.  ``streaming.persistence.
WriteBehindSink(l2=...)`` writes entries at flush/read *execution* time on
the owning partition's worker, so an L2 hit is bit-identical to the
ordered durable read it replaces.

The slot-based resident set (``ResidencyMap``) and oversized-group
splitting of the JAX package are not ported yet: they arrive with the
bounded-residency drivers (ROADMAP.md, queue 1 item 7).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional

import numpy as np

__all__ = ["HostL2Cache"]


# distinguishes "key not cached" from a cached-absence ``None`` entry in
# byte accounting (``HostL2Cache.put_rows``)
_L2_MISS = object()


class HostL2Cache:
    """Host-RAM second level between device slots and the durable store.

    Values are *packed* SerDe rows (``bytes`` of exactly
    ``SerDe.row_bytes()``, the same bytes ``pack_rows`` emits and
    ``multi_put`` stores) — promotion and demotion move bytes, never
    unpack/repack, so an L2 hit is bit-identical to the durable read it
    replaces.  A ``None`` value is a *cached absence*: an authoritative
    durable read returned no row for the key, so a probe hit returns
    "no row" without touching the store and the hydration path builds the
    same cold-init defaults a store miss would.  Absence markers are only
    ever written by ``fill_from_read`` with the result of an actual store
    read — never invented at demote time — so a marker can never shadow a
    durable row that exists (in particular a row LRU-evicted under a
    capacity bound, or one written by a previous run of the process).

    Coherence contract (why a hit is always current):

    * entries are written by ``WriteBehindSink`` on the owning partition's
      store-worker thread, at ``multi_put`` *execution* time (flush rows,
      ``put_rows``) or ``multi_get`` *execution* time (read results, rows
      and absences, ``fill_from_read``); each key belongs to exactly one
      partition, so all cache writes for a key are serialized on one
      thread and a filled read result is the store's FIFO-ordered value
      at that point (a flush queued behind the read overwrites it at its
      own execution time);
    * ``demote`` (driver thread, at slot eviction) only *refreshes* the
      recency of a present entry — it never inserts or overwrites, so
      racing with the key's in-flight flush is harmless whichever order
      the lock grants.

    ``capacity=None`` is unbounded; otherwise LRU (recency refreshed by
    probes, inserts and demotions) with eldest-out eviction — an evicted
    entry simply falls through to the durable store again.
    ``capacity_bytes=`` sizes the cache by resident payload bytes instead
    of (or in addition to) entries: crossing the high watermark on insert
    sheds eldest entries down to ``shed_low_frac`` of the cap
    (``shed_rows`` counts them), so a burst of inserts pays one amortized
    shed sweep rather than one eviction per insert.  Both bounds are
    purely capacity policy — a shed entry falls through to the durable
    store exactly like a ``capacity`` eviction, so contents stay
    bit-identical to any other bound (or none).  Thread-safe via one
    lock; counters are read unlocked for stats snapshots.
    """

    #: approximate per-entry host overhead (dict slot + key + bytes-object
    #: header) counted on top of the payload, so an absence marker still
    #: has nonzero cost and ``capacity_bytes`` bounds real memory, not
    #: just payload
    ENTRY_OVERHEAD = 96

    def __init__(self, capacity: Optional[int] = None,
                 capacity_bytes: Optional[int] = None,
                 shed_low_frac: float = 0.9):
        if capacity is not None and capacity <= 0:
            raise ValueError("l2 capacity must be positive (None: unbounded)")
        if capacity_bytes is not None and capacity_bytes <= 0:
            raise ValueError("l2 capacity_bytes must be positive "
                             "(None: unbounded)")
        if not 0.0 < shed_low_frac <= 1.0:
            raise ValueError("shed_low_frac must be in (0, 1]")
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes
        self.shed_low_frac = float(shed_low_frac)
        self._rows: "OrderedDict[int, Optional[bytes]]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.demotions = 0
        self.inserts = 0
        self.read_fills = 0
        self.capacity_evictions = 0
        self.shed_rows = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    @property
    def bytes(self) -> int:
        """Resident entry cost in bytes (payload + per-entry overhead)."""
        return self._bytes

    @classmethod
    def _entry_cost(cls, r: Optional[bytes]) -> int:
        return cls.ENTRY_OVERHEAD + (0 if r is None else len(r))

    def put_rows(self, keys, rows) -> None:
        """Insert/overwrite packed rows (flush path, store-worker thread).

        ``rows``: ``[N, row_bytes] uint8`` (a ``pack_rows`` output slice)
        or any sequence of row-sized byte strings, aligned with ``keys``.
        """
        with self._lock:
            for k, r in zip(keys, rows):
                k = int(k)
                old = self._rows.pop(k, _L2_MISS)
                if old is not _L2_MISS:
                    self._bytes -= self._entry_cost(old)
                r = bytes(r)
                self._rows[k] = r
                self._bytes += self._entry_cost(r)
                self.inserts += 1
            self._evict_over_capacity()

    def probe(self, keys):
        """Look up packed rows: ``(rows, hit)`` aligned with ``keys``.

        ``rows[i]`` is the packed row bytes when present, ``None`` on a
        cached absence *or* a miss — ``hit[i]`` disambiguates (a hit with
        ``None`` means "authoritatively no durable row").  Hits refresh
        LRU recency.
        """
        rows: List[Optional[bytes]] = []
        hit = np.zeros(len(keys), bool)
        with self._lock:
            for i, k in enumerate(keys):
                k = int(k)
                if k in self._rows:
                    self._rows.move_to_end(k)
                    rows.append(self._rows[k])
                    hit[i] = True
                    self.hits += 1
                else:
                    rows.append(None)
                    self.misses += 1
        return rows, hit

    def contains(self, keys) -> np.ndarray:
        """Advisory presence mask — no stats, no recency (for counters)."""
        with self._lock:
            return np.fromiter((int(k) in self._rows for k in keys),
                               bool, count=len(keys))

    def demote(self, keys) -> None:
        """Record slot evictions (driver thread): refresh the LRU recency
        of entries already present (the victim's row or cached absence —
        both landed at flush/read *execution* time) so they outlive
        colder entries under a capacity bound.  Never inserts: a key
        whose entry was capacity-evicted (or never read) simply falls
        through to the durable store on its next hydration read — a
        demote-invented absence marker could shadow a real durable row.
        """
        with self._lock:
            for k in keys:
                k = int(k)
                if k in self._rows:
                    self._rows.move_to_end(k)
                self.demotions += 1

    def fill_from_read(self, keys, rows) -> None:
        """Cache an authoritative durable read result (store-worker
        thread, at ``multi_get`` execution time): promote returned rows
        and record absences (``rows[i] is None``) so repeat hydrations of
        the same key skip the store.  Insert-if-absent only — an entry
        already present (e.g. a flush that landed meanwhile) is newer
        than the read result and is never clobbered.
        """
        with self._lock:
            for k, r in zip(keys, rows):
                k = int(k)
                if k in self._rows:
                    self._rows.move_to_end(k)
                else:
                    r = None if r is None else bytes(r)
                    self._rows[k] = r
                    self._bytes += self._entry_cost(r)
                    self.read_fills += 1
            self._evict_over_capacity()

    def _pop_eldest(self) -> None:
        _, r = self._rows.popitem(last=False)
        self._bytes -= self._entry_cost(r)

    def _evict_over_capacity(self) -> None:
        if self.capacity is not None:
            while len(self._rows) > self.capacity:
                self._pop_eldest()
                self.capacity_evictions += 1
        if self.capacity_bytes is not None and self._bytes > self.capacity_bytes:
            # high/low watermark shed: drop eldest down to the low mark so
            # an insert burst pays one sweep, not one eviction per insert
            low = self.capacity_bytes * self.shed_low_frac
            while self._rows and self._bytes > low:
                self._pop_eldest()
                self.shed_rows += 1
