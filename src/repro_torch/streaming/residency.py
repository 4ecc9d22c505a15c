"""Slot-based resident set for bounded device state (host-side plane).

The counterpart of ``repro.streaming.residency``, copied unchanged: the
module is plain numpy and stdlib, so the port keeps its own copy rather
than importing the JAX package.

The paper's premise (§1, §4) is that per-key statistics live in a
disk-backed KV store; device memory holds only what the stream is touching
*now*.  ``ResidencyMap`` is the host-side control plane for that split: the
device ``ProfileState`` holds ``n_slots`` rows (``S << num_keys``), this map
assigns slots to global entity ids one flush group at a time, and the
streaming drivers (``core.stream.run_stream(residency=...)``,
``features.engine.ShardedFeatureEngine.run_stream``) hydrate misses from
the durable stores and recycle victim slots — residency becomes a tunable
knob instead of a hard device-memory capacity wall.

Why eviction needs no device read-back: the durable profile columns
(``last_t``/``v_f``/``agg``) change only on persisted (``z``) events, and
the write-behind sink flushes every flush group's post-update rows — so by
the time a slot is recycled, the KV store already holds the victim's
current durable row.  The control column (``v_full``/``last_t_full``) is
durable only under the full-stream policies that feed it into decisions
('full'/'unfiltered'); under thinning policies an evicted key restarts it
cold on rehydration, exactly like the per-event worker and the
restart-from-store path (see ``streaming.persistence``).  That is what
makes eviction pure host bookkeeping and evict→rehydrate bit-exact on
everything decisions and features read.

Assignment contract (per flush group):

* every distinct valid key of the group gets exactly one slot, held for the
  whole group (conflict-free: two group keys never share a slot);
* keys of the *current* group are pinned — the eviction scan cannot recycle
  them (a group with more distinct keys than slots is a capacity error,
  raised before any state is mutated; the streaming drivers avoid it by
  splitting oversized groups with ``split_oversized_group`` first);
* victims are chosen per the ``eviction=`` knob (names in ``EVICTION``):
  ``"second_chance"`` grants one extra clock rotation to slots referenced
  since the last sweep (classic clock / second-chance), ``"fifo"`` recycles
  strictly in hand order (the strawman baseline), and ``"priority"``
  replaces the blind sweep with a vectorized priority array over slots —
  predicted re-reference (per-slot touch frequency over recency) weighted
  by modeled rehydration cost, lowest priority evicted first (the
  vectorized-priority idiom of prioritized replay buffers).

The map is plain numpy and thread-free: drivers call ``assign_group`` from
the dispatch thread only.  Per-group and cumulative counters live in
``ResidencyStats`` (hit rate, unique misses == hydration reads, evictions).

``HostL2Cache`` is the host-memory tier *between* the device slots and the
durable store: packed SerDe rows (``kvstore.SerDe.pack_rows`` bytes, no
unpack/repack round-trip) keyed by global entity id.  Slot eviction
*demotes* the victim into it (a recency refresh of its entry) and
hydration reads probe it before touching the durable store — see
``streaming.persistence.WriteBehindSink(l2=...)`` for the coherence
contract (entries are written at flush/read *execution* time on the
owning partition's worker, so an L2 hit is bit-identical to the ordered
durable read it replaces).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import List, NamedTuple, Optional

import numpy as np

__all__ = ["ResidencyMap", "ResidencyStats", "GroupAssignment", "EVICTION",
           "HostL2Cache", "split_oversized_group"]

# Eviction policies of the slot recycler; README.md documents each and
# scripts/check_docs.py lints the two lists against each other (like the
# sharded engine's LAYOUTS).
EVICTION = ("second_chance", "fifo", "priority")


@dataclasses.dataclass
class ResidencyStats:
    """Cumulative residency accounting (`last` holds the newest group's)."""
    groups: int = 0
    lookups: int = 0        # valid event lanes translated
    unique_keys: int = 0    # sum over groups of distinct valid keys
    hits: int = 0           # distinct keys already resident
    misses: int = 0         # distinct keys hydrated (== hydration reads)
    evictions: int = 0      # slots recycled from a live key
    peak_resident: int = 0
    # oversized flush groups split into fitting sub-groups by the drivers
    # (counts the *extra* sub-groups: a group split in three adds two)
    splits: int = 0

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate()
        return d

    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)


class GroupAssignment(NamedTuple):
    """One flush group's slot plan (all arrays are host numpy)."""

    slot: np.ndarray        # int32 [n_lanes] per-lane slot (0 on invalid)
    miss_keys: np.ndarray   # int64 [M] distinct keys to hydrate, in slot-
    miss_slots: np.ndarray  # int32 [M] assignment order
    # True where the miss is this run's *first touch* of the key: no flush
    # of this run can hold it, so its hydration read needs no ordering
    # barrier against in-flight flushes (the drivers use the sink's
    # unordered fast lane for these)
    miss_fresh: np.ndarray  # bool [M]
    evicted: np.ndarray     # int64 [V] keys whose slot was recycled
    hits: int               # distinct keys already resident


class ResidencyMap:
    """Key→slot table with clock/second-chance slot recycling.

    ``num_keys`` sizes the (host) inverse table — 4 bytes per key, the
    O(num_keys) plane this design *keeps* on the host so the O(row) plane
    on device can shrink to ``n_slots`` rows.
    """

    def __init__(self, num_keys: int, n_slots: int,
                 eviction: str = "second_chance"):
        if eviction not in EVICTION:
            raise ValueError(f"unknown eviction {eviction!r}; choose from "
                             f"{EVICTION}")
        if n_slots <= 0:
            raise ValueError("need at least one resident slot")
        self.num_keys = int(num_keys)
        self.n_slots = int(n_slots)
        self.eviction = eviction
        self.slot_of_key = np.full(self.num_keys, -1, np.int32)
        self.key_of_slot = np.full(self.n_slots, -1, np.int64)
        self._seen = np.zeros(self.num_keys, bool)  # ever resident this run
        self._ref = np.zeros(self.n_slots, bool)       # second-chance bit
        self._pin = np.full(self.n_slots, -1, np.int64)  # group that pinned
        self._hand = 0
        self._resident = 0
        # Per-slot signals for eviction="priority" (maintained under every
        # policy — three small arrays): last-touched group, event-lane touch
        # count while resident, and modeled hydration cost of re-admitting
        # the key (a rehydration costs an ordered durable read; a first
        # touch only the cheap unordered fast-lane probe).
        self._touch = np.zeros(self.n_slots, np.int64)
        self._freq = np.zeros(self.n_slots, np.float64)
        self._cost = np.ones(self.n_slots, np.float32)
        self.stats = ResidencyStats()

    # ------------------------------------------------------------ queries
    @property
    def resident(self) -> int:
        return self._resident

    def resident_keys(self) -> np.ndarray:
        """Keys currently holding a slot (unordered)."""
        return self.key_of_slot[self.key_of_slot >= 0].copy()

    def seen(self, keys) -> np.ndarray:
        """True where a key has ever been resident this run — i.e. a read
        for it is a *re*hydration and must ride the sink FIFO behind any
        in-flight flush that may hold it (the serving frontend uses this
        to account prefetch-after-evict separately from first touches)."""
        return self._seen[np.asarray(keys, np.int64).reshape(-1)].copy()

    # --------------------------------------------------------- assignment
    def assign_group(self, keys, valid: Optional[np.ndarray] = None,
                     batch_take: bool = False) -> GroupAssignment:
        """Assign one slot per distinct valid key for the coming group.

        ``keys``: global entity ids, any shape (flattened); ``valid``: the
        padding mask (all-valid when omitted).  Hits refresh the reference
        bit; misses take slots from the clock sweep, evicting unpinned
        victims; the whole group is pinned against its own evictions.
        Raises ``ValueError`` (before touching the table) when the group
        holds more distinct keys than slots.

        ``batch_take=True`` selects all of the group's victim slots in one
        vectorized pass (``_take_slots_clock``) instead of a per-miss hand
        walk, and scatters the slot-table bookkeeping with array ops.  The
        chosen slots, their order, the reference-bit mutations and the
        final hand position are bit-identical to the serial walk (pinned
        by ``tests/test_pipelined.py``); only the host cost changes.  The
        pipelined drivers plan groups with it so the prep thread's work
        fits under the device window.
        """
        keys = np.asarray(keys, np.int64).reshape(-1)
        if valid is None:
            v = None
            vk = keys
        else:
            v = np.asarray(valid, bool).reshape(-1)
            vk = keys[v]
        st = self.stats
        gid = st.groups
        # Steady state (all hits) must stay sort-free: distinct hits are
        # counted with a slot-presence bincount and only *miss* keys (few,
        # once warm) go through np.unique.
        lane_slot = self.slot_of_key[vk]
        miss_lane = lane_slot < 0
        hit_lane_slots = lane_slot[~miss_lane]
        if hit_lane_slots.size:
            hit_counts = np.bincount(hit_lane_slots, minlength=self.n_slots)
            n_hit = int(np.count_nonzero(hit_counts))
        else:
            hit_counts = None
            n_hit = 0
        miss_keys, miss_counts = np.unique(vk[miss_lane], return_counts=True)
        if n_hit + miss_keys.size > self.n_slots:
            raise ValueError(
                f"flush group {gid} holds {n_hit + miss_keys.size} distinct "
                f"keys but the resident set has only {self.n_slots} slots; "
                f"raise the residency budget, shrink batch/sink_group, or "
                f"pre-split the group with split_oversized_group (the "
                f"streaming drivers do)")
        st.groups += 1
        st.lookups += int(vk.size)
        st.unique_keys += n_hit + int(miss_keys.size)
        self._ref[hit_lane_slots] = True
        self._pin[hit_lane_slots] = gid
        if hit_counts is not None:
            self._freq += hit_counts
            self._touch[hit_lane_slots] = gid

        miss_slots = np.empty(miss_keys.size, np.int32)
        miss_fresh = ~self._seen[miss_keys]
        self._seen[miss_keys] = True
        if batch_take and miss_keys.size:
            takes = (self._take_slots_priority(gid, miss_keys.size)
                     if self.eviction == "priority"
                     else self._take_slots_clock(gid, miss_keys.size))
            # vectorized bookkeeping: takes are distinct slots, so every
            # scatter below lands each slot exactly once
            old = self.key_of_slot[takes]
            ev = old >= 0
            evicted_keys = old[ev]
            self.slot_of_key[evicted_keys] = -1
            self.key_of_slot[takes] = miss_keys
            self.slot_of_key[miss_keys] = takes
            self._ref[takes] = True
            self._pin[takes] = gid
            self._touch[takes] = gid
            self._freq[takes] = miss_counts.astype(np.float64)
            self._cost[takes] = np.where(miss_fresh, 1.0, 2.0)
            miss_slots[:] = takes
            evicted = list(evicted_keys)
        else:
            takes = (self._take_slots_priority(gid, miss_keys.size)
                     if self.eviction == "priority" else None)
            evicted = []
            for i, k in enumerate(miss_keys):
                s = (int(takes[i]) if takes is not None
                     else self._take_slot(gid))
                old = self.key_of_slot[s]
                if old >= 0:
                    self.slot_of_key[old] = -1
                    evicted.append(old)
                self.key_of_slot[s] = k
                self.slot_of_key[k] = s
                self._ref[s] = True
                self._pin[s] = gid
                self._touch[s] = gid
                self._freq[s] = float(miss_counts[i])
                self._cost[s] = 1.0 if miss_fresh[i] else 2.0
                miss_slots[i] = s

        st.hits += n_hit
        st.misses += int(miss_keys.size)
        st.evictions += len(evicted)
        self._resident += int(miss_keys.size) - len(evicted)
        st.peak_resident = max(st.peak_resident, self._resident)

        if miss_keys.size:        # refresh the lanes that just got slots
            lane_slot[miss_lane] = self.slot_of_key[vk[miss_lane]]
        if v is None:
            slot = lane_slot.astype(np.int32)
        else:
            slot = np.zeros(keys.size, np.int32)
            slot[v] = lane_slot
        return GroupAssignment(
            slot=slot, miss_keys=miss_keys, miss_slots=miss_slots,
            miss_fresh=miss_fresh, evicted=np.asarray(evicted, np.int64),
            hits=n_hit)

    def _take_slot(self, gid: int) -> int:
        """Clock sweep: next free or evictable slot (current group pinned).

        Terminates because the group pins at most ``uniq <= n_slots`` slots
        and at the time of the m-th take fewer than ``uniq`` are pinned, so
        an unpinned slot always exists; second-chance reference bits are
        cleared on first pass, bounding the sweep to two rotations.
        """
        second = self.eviction == "second_chance"
        while True:
            s = self._hand
            self._hand = (self._hand + 1) % self.n_slots
            if self._pin[s] == gid:
                continue
            if self.key_of_slot[s] < 0:
                return s
            if second and self._ref[s]:
                self._ref[s] = False
                continue
            return s

    def _take_slots_clock(self, gid: int, m: int) -> np.ndarray:
        """Vectorized clock sweep: ``m`` sequential ``_take_slot`` calls
        simulated in one pass, bit-identical in every observable — chosen
        slots and their order, which reference bits drop, and the final
        hand position.

        The serial walk's structure makes this possible: within one
        rotation each position is visited at most once, so rotation 1
        takes exactly the unpinned slots that are free or unreferenced
        (in hand order), clears the reference bit of every *visited*
        unpinned+occupied+referenced slot, and rotation 2 takes those
        cleared slots (again in hand order) — the walk never needs a
        third rotation because the two sequences together cover every
        unpinned slot.  The only care point is the stop: reference bits
        drop only at positions the serial walk actually reached before
        its ``m``-th take.
        """
        S = self.n_slots
        rot = (np.arange(S) + self._hand) % S       # slots in walk order
        unpinned = self._pin[rot] != gid
        free = self.key_of_slot[rot] < 0
        if self.eviction == "second_chance":
            ref = self._ref[rot]
            idx1 = np.nonzero(unpinned & (free | ~ref))[0]
            clear = unpinned & ~free & ref
            if m <= idx1.size:
                last = int(idx1[m - 1])
                # visited rot positions are 0..last; the slot at ``last``
                # is a take, so only clears strictly before it happen
                self._ref[rot[np.nonzero(clear[:last])[0]]] = False
                takes = rot[idx1[:m]]
            else:
                self._ref[rot[clear]] = False       # full first rotation
                idx2 = np.nonzero(clear)[0]
                k2 = m - idx1.size
                last = int(idx2[k2 - 1])
                takes = np.concatenate([rot[idx1], rot[idx2[:k2]]])
        else:                                       # fifo: one rotation
            idx1 = np.nonzero(unpinned)[0]
            last = int(idx1[m - 1])
            takes = rot[idx1[:m]]
        self._hand = int((self._hand + last + 1) % S)
        return takes.astype(np.int32)

    def _take_slots_priority(self, gid: int, m: int) -> np.ndarray:
        """Cost-aware batch victim selection for ``eviction="priority"``.

        One vectorized pass per group instead of a per-miss hand walk:
        each occupied slot's priority is its predicted re-reference value —
        touch frequency while resident over groups since last touch —
        weighted by the modeled cost of bringing the key back (rehydrated
        keys ride the ordered durable-read FIFO, twice a fresh touch).
        Free slots sort first (-inf), the current group's pinned slots are
        unelectable (+inf; the capacity check guarantees ``m`` unpinned
        slots exist), and the stable argsort keeps victim order
        deterministic for reproducible eviction streams.
        """
        age = (gid - self._touch).astype(np.float64) + 1.0
        prio = np.where(self.key_of_slot < 0, -np.inf,
                        self._freq * self._cost / age)
        prio[self._pin == gid] = np.inf
        order = np.argsort(prio, kind="stable")
        return order[:m].astype(np.int32)


def split_oversized_group(keys, valid: Optional[np.ndarray],
                          capacity: int) -> List[np.ndarray]:
    """Split a flush group into key-complete segments that fit ``capacity``.

    Returns boolean lane masks (each the full group shape, flattened) that
    partition the valid lanes: distinct keys are assigned to segments in
    first-appearance order, ``capacity`` keys per segment, and every lane
    follows its key's segment.  Two properties make dispatching the
    segments as consecutive sub-groups bit-exact and safe:

    * **key-complete** — all of a key's lanes land in one segment, in
      their original relative order, so each engine pass sees the key's
      entire event run exactly like the unsplit dispatch would (per-key
      state math never observes a chunk boundary, which keeps *fast* mode
      bit-exact too) and per-key FIFO order is preserved;
    * **cross-key reordering is free** — profile states are per-key and
      thinning RNG is keyed on global entity ids, so interleaving between
      different keys' lanes carries no information.

    Each sub-group flushes as its own atomic sink batch: the flush-group
    fsync boundary only gets *finer*, never torn.  The common case (group
    already fits) costs one ``np.unique`` and returns a single mask.
    """
    keys = np.asarray(keys, np.int64).reshape(-1)
    if capacity <= 0:
        raise ValueError("need a positive slot capacity to split against")
    if valid is None:
        valid = np.ones(keys.size, bool)
    valid = np.asarray(valid, bool).reshape(-1)
    idx = np.nonzero(valid)[0]
    if idx.size <= capacity:
        # <= capacity valid lanes bounds distinct keys too: the common
        # steady-state case skips the np.unique entirely
        return [valid.copy()]
    vk = keys[idx]
    uniq, first = np.unique(vk, return_index=True)
    if uniq.size <= capacity:
        return [valid.copy()]
    seg_of_uniq = np.empty(uniq.size, np.int64)
    seg_of_uniq[np.argsort(first, kind="stable")] = \
        np.arange(uniq.size) // capacity
    lane_seg = seg_of_uniq[np.searchsorted(uniq, vk)]
    masks: List[np.ndarray] = []
    for j in range(int(lane_seg.max()) + 1):
        m = np.zeros(keys.size, bool)
        m[idx[lane_seg == j]] = True
        masks.append(m)
    return masks


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
