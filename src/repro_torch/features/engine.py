"""Entity-partitioned (sharded) feature engine (PyTorch).

The counterpart of ``repro.features.engine``'s ``ShardedFeatureEngine``.
The paper's partitioned workers (§5.3) are processes here: with a mesh
(``mesh=``, a 1-D ``torch.distributed`` ``DeviceMesh`` from
``launch.mesh.make_shard_mesh``) each rank is one shard, owns a subset of
the entities and steps only its own rows, with no collective on the
decision or update path.  Without a mesh one card is one shard, which owns
every entity.  The engine holds no decision math of its own — it routes
events under its layout and composes the core step, so every decision +
read-modify-write runs through the same keyed ``thinning_rmw`` launch as
``core.engine``.

Layouts (``layout=`` constructor option, names in ``LAYOUTS``):

* ``layout="block"`` (default) — shard ``s`` owns entities with
  ``key % n_shards == s`` at local row ``key // n_shards`` (one card: key
  k at row k).  Under heavy key skew the hottest shard sets the stream's
  block count and every other shard pads up to it.
* ``layout="virtual"`` — keys map onto virtual shards placed by
  volume-weighted power-of-two-choices (``distributed.rebalance``),
  cutting the padded-block waste on skewed streams; each rank holds its
  slice of the layout's ``gid_of_row``, and an inverse gather at
  ``materialize`` keeps user-visible entity ids unchanged.

Determinism: the step feeds each event's *global* entity id to the core
step's ``rng_entity`` hook — ``local_row * n_shards + shard`` under the
block layout, the rank's slice of ``gid_of_row`` under the virtual one —
so the counter-based thinning RNG sees exactly the counters ``core.engine``
sees on the same stream: decisions are bit-identical for any shard count
and either layout.

Streaming: every rank receives the whole flat stream, routes it with the
shared host code (``route``, ``route_stream_blocks``) and keeps its own
column of the ``[n_blocks, n_shards * B]`` blocks; every rank steps the
same global block count (a light shard's all-padding blocks run too).
``run_stream`` drives them through ``core.stream``'s drivers: the block
loop, the write-behind sink path and, with ``residency=``, the slot-based
resident set (``init_resident_state``), each rank with its own
``ResidencyMap``.  The state is updated in place (``core.stream``).  The
collectives (``distributed.collectives``) gather what the JAX engine
returns as global arrays: the stream-order ``StepInfo``, the write count,
``materialize``/``materialize_cold`` placed by owner, and checkpoints
(``checkpoint.manager``).  Storage is owned by rank: ``make_sink`` opens
the rank's own partition only and refuses rows of any other.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import engine as core_engine
from repro_torch.core import estimators
from repro_torch.core import stream as core_stream
from repro_torch.core.thinning import prng_key
from repro_torch.core.types import (EngineConfig, Event, ProfileState,
                                    StepInfo, init_state, resolve_device)
from repro_torch.distributed import collectives, rebalance
from repro_torch.launch.mesh import shard_of_mesh
from repro_torch.streaming import persistence

# The layouts this engine supports (the JAX package's names).
LAYOUTS = ("block", "virtual")


def stream_block_counts(shard: np.ndarray, n_shards: int,
                        batch_per_shard: int) -> Tuple[np.ndarray, int]:
    """(per-shard event counts, n_blocks) for a routed stream — the single
    definition of the packer's block-count rule (n_blocks follows the most
    loaded shard), shared by ``route_stream_blocks`` and the
    ``stream_layout_stats`` accounting."""
    counts = np.bincount(shard, minlength=n_shards)
    n_blocks = max(1, -(-int(counts.max()) // int(batch_per_shard))) \
        if shard.size else 1
    return counts, n_blocks


def route_stream_blocks(shard: np.ndarray, local: np.ndarray, q: np.ndarray,
                        t: np.ndarray, n_shards: int, batch_per_shard: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray, np.ndarray, int]:
    """Pack routed events into flat ``[n_blocks * n_shards * B]`` blocks.

    Shard ``s`` owns block columns ``[s*B, (s+1)*B)`` and its events are
    packed in stream order, so per-key ordering is preserved; every event
    is retained exactly once.  Returns ``(key, q, t, valid, slot,
    n_blocks)`` where the first four are flat arrays (``key`` holds
    ``local``) and ``slot`` is each input event's flat block-major slot.
    """
    shard = np.asarray(shard)
    n, B = int(n_shards), int(batch_per_shard)
    counts, n_blocks = stream_block_counts(shard, n, B)
    W = n * B
    out_key = np.zeros(n_blocks * W, np.int32)
    out_q = np.zeros(n_blocks * W, np.float32)
    out_t = np.zeros(n_blocks * W, np.float32)
    out_valid = np.zeros(n_blocks * W, bool)
    # rank of each event within its shard, in stream order
    order = np.argsort(shard, kind="stable")
    starts = np.cumsum(counts) - counts
    rank = np.empty(shard.size, np.int64)
    rank[order] = np.arange(shard.size) - starts[shard[order]]
    slot = (rank // B) * W + shard * B + rank % B
    out_key[slot] = local
    out_q[slot] = q
    out_t[slot] = t
    out_valid[slot] = True
    return out_key, out_q, out_t, out_valid, slot, n_blocks


class ShardedFeatureEngine:
    """Vectorized persistence-path control over a shard's entities."""

    def __init__(self, cfg: EngineConfig, num_entities: int, mesh=None,
                 data_axes: Tuple[str, ...] = ("data",),
                 mode: str = "fast", layout: str = "block",
                 key_weights: Optional[np.ndarray] = None,
                 n_virtual: Optional[int] = None, seed: int = 0,
                 device=None):
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; choose from "
                             f"{LAYOUTS}")
        self.cfg = cfg
        self.mode = mode
        self.layout = layout
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        if mesh is None:
            self.n_shards, self.shard, self.group = 1, 0, None
            self.device = resolve_device(device)
        else:
            self.n_shards, self.shard, self.group = shard_of_mesh(
                mesh, self.data_axes)
            # a mesh names its device type; the rank's card is the one
            # make_shard_mesh pinned
            self.device = resolve_device(mesh.device_type if device is None
                                         else device)
        n, s = self.n_shards, self.shard
        if layout == "virtual":
            # frozen skew-aware layout; see distributed/rebalance.py
            self.vlayout = rebalance.build_layout(
                num_entities, n, key_weights=key_weights,
                n_virtual=n_virtual, seed=seed)
            E = self.entities_per_shard = self.vlayout.entities_per_shard
            self.num_entities = self.vlayout.num_rows
            self._row_of_key = torch.as_tensor(
                np.asarray(self.vlayout.row_of_key, np.int64),
                device=self.device)
            # this shard's slice of gid_of_row: local row -> global id
            self._gid_host = np.asarray(self.vlayout.gid_of_row,
                                        np.int64)[s * E:(s + 1) * E]
            self._step_consts = (torch.as_tensor(self._gid_host,
                                                 device=self.device),)
        else:
            self.vlayout = None
            # round entities up so every shard owns the same row count
            self.entities_per_shard = -(-int(num_entities) // n)
            self.num_entities = self.entities_per_shard * n
            self._row_of_key = None
            self._step_consts = ()
        self._local_step = core_engine.make_step(cfg, mode)
        self._step = None      # public (state, ev, rng) wrapper

    # ------------------------------------------------------------ state
    def init_state(self) -> ProfileState:
        """This shard's rows: ``entities_per_shard`` of them (every entity
        on one card)."""
        return init_state(self.entities_per_shard, len(self.cfg.taus),
                          device=self.device)

    def init_resident_state(self, slots_per_shard: int) -> ProfileState:
        """Bounded device state: ``slots_per_shard`` resident slots on this
        shard instead of one row per owned entity — the state for
        ``run_stream(residency=...)``.  Device memory then scales with the
        budget, not ``num_entities``."""
        return init_state(int(slots_per_shard), len(self.cfg.taus),
                          device=self.device)

    # ------------------------------------------------ host-side routing
    def route(self, key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(shard, local row) of each key under the active layout."""
        key = np.asarray(key)
        if self.layout == "virtual":
            return (self.vlayout.shard_of_key[key],
                    self.vlayout.local_of_key[key])
        return key % self.n_shards, key // self.n_shards

    def partition_events(self, key: np.ndarray, q: np.ndarray,
                         t: np.ndarray, batch_per_shard: int) -> Event:
        """Route a host batch under the active layout: this shard's events,
        local rows in ``key``, as one ``[B]`` Event on its device — the
        shard's column of the JAX engine's global ``[n_shards * B]`` Event
        (events beyond ``B`` a shard are dropped from this micro-batch;
        ``run_stream`` drops none)."""
        shard, local = self.route(key)
        B = batch_per_shard
        out_key = np.zeros(B, np.int64)
        out_q = np.zeros(B, np.float32)
        out_t = np.zeros(B, np.float32)
        out_valid = np.zeros(B, bool)
        sel = np.nonzero(shard == self.shard)[0][:B]
        m = len(sel)
        out_key[:m] = local[sel]
        out_q[:m] = np.asarray(q)[sel]
        out_t[:m] = np.asarray(t)[sel]
        out_valid[:m] = True
        dev = lambda x: torch.from_numpy(x).to(self.device)
        return Event(key=dev(out_key), q=dev(out_q), t=dev(out_t),
                     valid=dev(out_valid))

    def _blocks(self, keys, qs, ts, batch_per_shard, rows=True):
        """This shard's host ``[n_blocks, B]`` column of a routed stream:
        local state rows (``rows=True``) or the global ids in the key
        column; ``slot`` maps events to the global blocks' flat slots."""
        with tracing.span("stream.route"):
            key = np.asarray(keys, np.int32)
            q = np.asarray(qs, np.float32)
            t = np.asarray(ts, np.float32)
            n, B = self.n_shards, int(batch_per_shard)
            shard, local = self.route(key)
            out_key, out_q, out_t, out_valid, slot, n_blocks = \
                route_stream_blocks(shard, local if rows else key, q, t, n,
                                    B)
            cols = slice(self.shard * B, (self.shard + 1) * B)
            blk = lambda x: np.ascontiguousarray(
                x.reshape(n_blocks, n * B)[:, cols])
            tracing.count("stream.blocks", n_blocks)
            return (blk(out_key), blk(out_q), blk(out_t), blk(out_valid),
                    slot, n_blocks)

    def partition_stream(self, key, q, t, batch_per_shard: int
                         ) -> Tuple[Event, np.ndarray]:
        """Route a flat host stream into this shard's ``[n_blocks, B]``
        blocks on its device.  Every event is retained exactly once (on
        its owner).  Returns (events, slot) where ``slot`` is the flat
        block-major slot of every input event in the global ``[n_blocks,
        n_shards * B]`` blocks, for mapping per-event outputs back to
        stream order."""
        kb, qb, tb, vb, slot, _ = self._blocks(key, q, t, batch_per_shard)
        dev = lambda x: torch.from_numpy(x).to(self.device)
        return Event(key=dev(kb.astype(np.int64)), q=dev(qb), t=dev(tb),
                     valid=dev(vb)), slot

    def stream_layout_stats(self, key, batch_per_shard: int) -> dict:
        """Host-side padding accounting for a stream under the active
        layout: ``padded_fraction`` is the share of block slots that carry
        no real event."""
        shard, _ = self.route(np.asarray(key, np.int64))
        B = int(batch_per_shard)
        counts, n_blocks = stream_block_counts(shard, self.n_shards, B)
        slots = n_blocks * self.n_shards * B
        return {"n_blocks": n_blocks, "slots": slots,
                "events": int(shard.size),
                "padded_fraction": float(1.0 - shard.size / slots),
                "max_shard_events": int(counts.max()) if shard.size else 0,
                "mean_shard_events": float(counts.mean())}

    # ------------------------------------------------------------- step
    def make_step(self):
        """(state, Event, rng) -> (state, StepInfo), memoized: the core
        step on this shard's rows with the layout's global ids as the RNG
        entities.  On a mesh ``Event`` is the shard's ``partition_events``
        column, the StepInfo is the shard's lanes and ``writes`` is the
        mesh's total (an all-reduce, the one collective of the JAX
        step)."""
        if self._step is None:
            raw, consts = self._raw_step, self._step_consts
            step = (lambda st, ev, rng: raw(st, ev, rng, *consts)) \
                if consts else raw
            if self.mesh is not None:
                local = step

                def step(st, ev, rng):
                    st, info = local(st, ev, rng)
                    return st, info._replace(writes=collectives.write_count(
                        info.writes, self.group))
            self._step = step
        return self._step

    def _raw_step(self, st, ev, rng, *consts):
        """The layout-aware step taking the layout table explicitly."""
        if self.layout == "virtual":
            (gid,) = consts
            return self._local_step(st, ev, rng,
                                    rng_entity=gid[ev.key.to(torch.int64)])
        if self.n_shards > 1:
            # local row l of shard s is global entity l * n + s
            ent = ev.key.to(torch.int64) * self.n_shards + self.shard
            return self._local_step(st, ev, rng, rng_entity=ent)
        return self._local_step(st, ev, rng)

    def _residency_step(self, st, ev_ent, rng):
        """Layout-agnostic step for the slot-based resident set:
        ``Event.key`` holds slots and the global ids ride as data."""
        ev, ent = ev_ent
        return self._local_step(st, ev, rng, rng_entity=ent)

    # ----------------------------------------------------------- stream
    @tracing.entry
    def run_stream(self, state: ProfileState, keys, qs, ts, *,
                   batch_per_shard: int = 1024, rng=None,
                   collect_info: bool = True, sink=None,
                   sink_group: int = 4, residency=None,
                   pipeline_depth: int = 1
                   ) -> Tuple[ProfileState, Union[StepInfo, torch.Tensor]]:
        """Drive the engine over a flat stream, updating ``state`` in place.

        On a mesh every rank passes the whole stream and steps its own
        column of the routed blocks; the result is the JAX engine's, on
        every rank: the StepInfo gathered into stream order, or the
        mesh's per-block write counts.

        ``sink``: optional write-behind persistence sink (``make_sink``):
        the stream then runs in flush groups of ``sink_group`` blocks and
        each group's thinned rows are flushed, keyed by global entity id,
        while the next group computes.  Caller flushes.

        ``residency``: per-shard slot budget (int) or a list of prebuilt
        ``streaming.residency.ResidencyMap``s, one per shard (a rank uses
        its own).  The state then holds ``S`` slots a shard
        (``init_resident_state``); misses hydrate from the shard's own
        store and victims recycle per the map's policy.  Each rank's map
        and hydration are its own: no padding to a mesh-wide width.
        Requires ``sink``.

        ``pipeline_depth``: as ``core.stream.run_stream`` — 1 is the
        serial flush-group loop, >= 2 the pipelined plane, bit-identical.

        Returns the state plus either a StepInfo in *stream order*
        (``collect_info=True``) or per-block write counts.
        """
        if rng is None:
            rng = prng_key(0)
        depth = int(pipeline_depth)
        if depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if depth > 1 and sink is None:
            raise ValueError(
                "pipeline_depth > 1 requires a sink: the pipelined plane "
                "overlaps host group prep with device compute across "
                "flush groups, which the block loop without a sink does "
                "not have")
        if sink is not None and sink.device != state.device:
            raise ValueError(f"the sink is for {sink.device} but the state "
                             f"lives on {state.device}")
        if residency is not None:
            state, info, slot = self._run_stream_residency(
                state, keys, qs, ts, batch_per_shard, rng, collect_info,
                sink, sink_group, residency, depth)
        elif sink is not None:
            state, info, slot = self._run_stream_sink(
                state, keys, qs, ts, batch_per_shard, rng, collect_info,
                sink, sink_group, depth)
        else:
            events, slot = self.partition_stream(keys, qs, ts,
                                                 batch_per_shard)
            state, info = core_stream.block_runner_for(
                self._raw_step, collect_info)(state, events, rng,
                                              *self._step_consts)
        if self.mesh is not None:
            if not collect_info:
                return state, collectives.write_count(info, self.group)
            return state, collectives.stream_order_info(info, slot,
                                                        self.group)
        if not collect_info:
            return state, info
        idx = torch.from_numpy(np.asarray(slot, np.int64)).to(state.device)
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))[idx]
        return state, StepInfo(
            z=flat(info.z), p=flat(info.p), lam_hat=flat(info.lam_hat),
            features=flat(info.features),
            writes=info.writes.sum().to(torch.int32))

    def _run_stream_sink(self, state, keys, qs, ts, batch_per_shard, rng,
                         collect_info, sink, sink_group, depth):
        """Write-behind flush-group loop: ``core.stream._drive_with_sink``
        over the shard's rows, with sink keys the *global* entity ids
        (``local * n + shard`` under the block layout, the shard's
        ``gid_of_row`` under the virtual one) so stored rows are keyed
        like the per-event worker's.
        """
        kb, qb, tb, vb, slot, n_blocks = self._blocks(keys, qs, ts,
                                                      batch_per_shard)
        if self.layout == "virtual":
            gid_host = self._gid_host[kb]
        else:
            gid_host = kb.astype(np.int64) * self.n_shards + self.shard
        group_of = core_stream.group_source(
            dict(key=kb.astype(np.int64), q=qb, t=tb, valid=vb),
            state.device, depth)
        state, outs = core_stream._drive_with_sink(
            core_stream.sink_step_for(self._raw_step, collect_info), state,
            n_blocks, max(1, int(sink_group)), group_of, rng, sink,
            sink_keys=gid_host, valid_host=vb, collect_info=collect_info,
            consts=self._step_consts, pipeline_depth=depth)
        return state, core_stream._concat_groups(
            outs, collect_info, len(self.cfg.taus), state.device), slot

    def _run_stream_residency(self, state, keys, qs, ts, batch_per_shard,
                              rng, collect_info, sink, sink_group,
                              residency, depth):
        """Slot-based resident-set loop: ``core.stream.
        _drive_with_residency`` over the shard's column, the blocks holding
        *global* ids (slots are a per-group decision of the shard's
        ResidencyMap in ``plan_group``)."""
        from repro_torch.streaming.residency import (ResidencyMap,
                                                     split_oversized_group)
        if sink is None:
            raise ValueError(
                "residency requires a write-behind sink: evicted slots "
                "rely on the durable store for rehydration")
        if isinstance(residency, (int, np.integer)):
            rmaps = [ResidencyMap(self.num_entities, int(residency))]
        else:
            rmaps = list(residency)
        if len(rmaps) != self.n_shards:
            raise ValueError(f"need one ResidencyMap per shard "
                             f"({self.n_shards}), got {len(rmaps)}")
        rmap = rmaps[self.shard]
        S = rmap.n_slots
        if state.num_entities != S:
            raise ValueError(
                f"state holds {state.num_entities} rows but the shard's "
                f"resident set has {S} slots; build it with "
                f"init_resident_state({S})")
        kb, qb, tb, vb, slot, n_blocks = self._blocks(
            keys, qs, ts, batch_per_shard, rows=False)
        serde, n_taus = sink.serde, len(self.cfg.taus)

        def plan_group(lo, hi):
            kseg, vseg = kb[lo:hi], vb[lo:hi]
            segs = split_oversized_group(kseg, vseg, S)
            if len(segs) > 1:
                rmap.stats.splits += len(segs) - 1
            plans = []
            for j, vmask in enumerate(segs):
                vm = vmask.reshape(kseg.shape)
                asn = rmap.assign_group(kseg, vm, batch_take=depth > 1)
                sink.demote(asn.evicted)
                slots = asn.slot.reshape(kseg.shape)

                def build(rows_fresh, rows_re, asn=asn):
                    rows = core_stream.merge_miss_rows(
                        asn.miss_fresh, rows_fresh, rows_re)
                    return core_stream.pack_hydration(
                        rows, asn.miss_slots, serde, S, n_taus)

                plans.append(core_stream._GroupPlan(
                    dict(key=slots.astype(np.int64), q=qb[lo:hi],
                         t=tb[lo:hi], valid=vm, ent=kseg.astype(np.int64)),
                    kseg.reshape(-1), vmask.reshape(-1),
                    asn.miss_keys[asn.miss_fresh],
                    asn.miss_keys[~asn.miss_fresh], build,
                    last=j == len(segs) - 1))
            return plans

        state, outs = core_stream._drive_with_residency(
            core_stream.residency_step_for(self._residency_step,
                                           collect_info),
            state, n_blocks, max(1, int(sink_group)), plan_group, rng, sink,
            collect_info=collect_info, pipeline_depth=depth)
        return state, core_stream._concat_groups(
            outs, collect_info, len(self.cfg.taus), state.device), slot

    # ------------------------------------------------------- persistence
    def make_sink(self, **kw) -> "persistence.WriteBehindSink":
        """A ``WriteBehindSink`` on this shard's device whose partitions
        mirror the layout's key -> shard map, so every durable row lands
        on the store of the shard that computed it.  On a mesh the sink
        opens this rank's partition only (``owned``) and refuses rows of
        any other: two ranks never write one store.  ``**kw`` passes
        through — in particular ``backend="durable", store_dir=...`` puts
        real WAL+compaction stores behind this engine (``part-<shard>/``
        under ``store_dir``); ``hydrate_from_dir`` is the matching restart
        path."""
        kw.setdefault("device", self.device)
        if self.mesh is not None:
            kw.setdefault("owned", (self.shard,))
        return persistence.WriteBehindSink(
            self.cfg, n_partitions=self.n_shards,
            partition_fn=lambda ks: self.route(np.asarray(ks))[0], **kw)

    def reopen_stores(self, store_dir: str, **kw):
        """Recover this shard's ``DurableStore`` partition from an on-disk
        directory (WAL replay + segment load, torn tails repaired): a list
        of one store, like ``make_sink().stores``."""
        from repro_torch.streaming.durable import open_partition_stores
        return open_partition_stores(store_dir, self.n_shards,
                                     owned=(self.shard,), **kw)

    def hydrate_from_dir(self, store_dir: str, **kw) -> ProfileState:
        """Crash recovery from bytes alone: reopen this shard's durable
        partition under ``store_dir`` and rebuild its rows from what the
        disk holds (the stores are closed again)."""
        stores = self.reopen_stores(store_dir, **kw)
        try:
            return self.hydrate_state(stores)
        finally:
            for s in stores:
                s.close()

    def _row_of_key_host(self) -> np.ndarray:
        """Host map: global entity id -> this shard's state row, per the
        layout (meaningful for the keys the shard owns)."""
        if self.layout == "virtual":
            return np.asarray(self.vlayout.local_of_key, np.int64)
        return np.arange(self.num_entities, dtype=np.int64) // self.n_shards

    def hydrate_state(self, stores) -> ProfileState:
        """Rebuild this shard's rows from its durable partition store (the
        restart path; persisted columns bit-exact to the lost exact-mode
        state).  ``stores``: ``make_sink().stores`` or ``reopen_stores``."""
        return persistence.hydrate_state(
            stores, self.entities_per_shard, len(self.cfg.taus),
            row_of_key=self._row_of_key_host(), device=self.device)

    def materialize(self, state: ProfileState, keys, t) -> torch.Tensor:
        """Read-only feature materialization by global entity id (the
        virtual layout gathers through ``row_of_key``).  On a mesh every
        rank passes the same keys: each key's features are computed on
        its owner and placed, so every rank gets them all."""
        if self.mesh is None:
            keys = torch.as_tensor(keys, device=state.device).to(
                torch.int64)
            rows = self._row_of_key[keys] if self.layout == "virtual" \
                else keys
        else:
            owner, local = self.route(_host_keys(keys))
            rows = torch.from_numpy(np.where(owner == self.shard, local, 0)
                                    .astype(np.int64)).to(state.device)
        t = torch.as_tensor(t, dtype=torch.float32, device=state.device)
        feats = core_engine.materialize_features(state, rows, t,
                                                 self.cfg.taus)
        if self.mesh is None:
            return feats
        return collectives.place_owned(feats, owner, self.group)

    def materialize_cold(self, stores, keys, t, l2_probe=None
                         ) -> torch.Tensor:
        """Score straight from durable bytes — restart as cold-start
        hydration, with no dense state table ever built.

        ``stores``: this shard's partition store (``make_sink().stores``
        or ``reopen_stores``).  The shard reads the keys it owns, one
        batched ``multi_get``, and unpacks them; on a mesh the rows are
        placed by owner on every rank (every rank passes the same keys).
        The same decay + materialize as ``materialize`` then runs on the
        device — so for persisted profiles the features equal those of a
        fully hydrated state, and absent keys score as fresh profiles.
        ``l2_probe``: the owning sink's ``l2_probe``; hits skip the
        durable gets (same bytes).
        """
        from repro_torch.streaming.kvstore import SerDe

        if len(stores) != 1:
            raise ValueError(f"materialize_cold takes this shard's one "
                             f"partition store, got {len(stores)}")
        keys_np = _host_keys(keys)
        n_taus = len(self.cfg.taus)
        serde = SerDe(n_taus)
        last_t = np.full(keys_np.size, -np.inf, np.float32)
        agg = np.zeros((keys_np.size, n_taus, 3), np.float32)
        part = self.route(keys_np)[0]
        sel = np.nonzero(part == self.shard)[0]
        if l2_probe is not None:
            rows, hit = l2_probe(keys_np[sel])
            rows = list(rows)
        else:
            rows = [None] * int(sel.size)
            hit = np.zeros(sel.size, bool)
        todo = np.nonzero(~hit)[0]
        if todo.size:
            got = stores[0].multi_get(keys_np[sel[todo]])
            for j, r in zip(todo, got):
                rows[int(j)] = r
        present = [i for i, r in enumerate(rows) if r is not None]
        if present:
            lt, _, ag, _, _ = serde.unpack_rows(
                [rows[i] for i in present], keys=keys_np[sel[present]],
                partition=self.shard)
            last_t[sel[present]] = lt.astype(np.float32)
            agg[sel[present]] = ag
        last_t, agg = torch.from_numpy(last_t), torch.from_numpy(agg)
        if self.mesh is not None:
            last_t = collectives.place_owned(last_t, part, self.group)
            agg = collectives.place_owned(agg, part, self.group)
        dev = self.device
        taus = torch.tensor(self.cfg.taus, dtype=torch.float32, device=dev)
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        agg_now = estimators.decay_to(agg.to(dev), last_t.to(dev), t, taus)
        return estimators.materialize(agg_now)


def _host_keys(keys) -> np.ndarray:
    """Entity ids as a flat int64 host array."""
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu()
    return np.asarray(keys, np.int64).reshape(-1)
