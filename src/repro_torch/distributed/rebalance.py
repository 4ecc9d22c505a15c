"""Skew-aware virtual-shard rebalancing for the entity-partitioned engine.

The block layout (``features.engine`` default) owns entities by
``key % n_shards``, so under the heavy key skew the paper targets (Zipf
regimes where a fraction of a percent of keys carries 80% of the volume) the
shard holding the hottest keys sets the block count of the whole sharded
stream and every other shard pads up to it.  This module provides the
``layout="virtual"`` alternative: keys map onto ``V >> n_shards`` *virtual*
shards, and virtual shards are placed onto physical shards with
power-of-two-choices weighted by observed key volume, so the maximum
per-shard event load — and with it the padded-block waste — approaches the
mean.  Everything happens in the host-side layout layer: no control plane,
no cross-worker coordination, no change to the decision or update path
(the paper's §5.3 design goal is preserved).

Layout contract
---------------
* **Placement.**  ``virtual_shard_of(key) = key % n_virtual``;
  ``place_virtual_shards`` assigns each virtual shard to one of two
  seed-deterministic candidate physical shards, greedily in descending
  weight order, choosing the lighter-loaded candidate.  The placement is a
  pure function of ``(num_entities, n_shards, key_weights, n_virtual,
  seed)`` — two engines built with the same arguments route identically.
* **Rows.**  Each key owns exactly one state row:
  ``row_of_key[k] = shard_of_key[k] * entities_per_shard + local_of_key[k]``.
  ``gid_of_row`` is the inverse map (padding rows hold the sentinel
  ``num_entities``); the engine feeds it to the core step's ``rng_entity``
  hook so counter-based thinning decisions stay bit-identical to the local
  and block-layout engines for any placement.
* **Gather on materialize.**  User-visible entity ids never change; the
  scoring path gathers ``state[row_of_key[keys]]``, which is the only place
  the inverse map is consulted on-device.

Side tables
-----------
The layout tables (``gid_of_row`` / ``row_of_key``) are engine-owned
constants, read by the block driver beside the state and never aliasing a
``ProfileState`` leaf.

This module is the counterpart of ``repro.distributed.rebalance``, copied
unchanged apart from this note: it is plain numpy, so the port keeps its
own copy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["DEFAULT_VIRTUAL_FACTOR", "VirtualLayout", "build_layout",
           "place_virtual_shards", "virtual_shard_of"]

# V = factor * n_shards unless the caller picks V explicitly: large enough
# that a single hot virtual shard holds only ~1/V of the key space, small
# enough that the host-side greedy placement stays negligible.
DEFAULT_VIRTUAL_FACTOR = 64


def virtual_shard_of(keys, n_virtual: int) -> np.ndarray:
    """Virtual shard of each key (deterministic, identity-permutation safe:
    workload generators already randomize key identity, so a plain modulus
    spreads hot keys uniformly over virtual shards)."""
    return np.asarray(keys) % int(n_virtual)


def place_virtual_shards(weights: np.ndarray, n_shards: int,
                         seed: int = 0) -> np.ndarray:
    """Power-of-two-choices placement of virtual shards onto physical shards.

    Virtual shards are visited in descending ``weights`` order; each draws
    two distinct seed-deterministic candidate shards and lands on the one
    with the smaller accumulated weight (first candidate on ties).  Greedy
    descending-weight placement with two choices is the classic
    load-balancing compromise: near-LPT balance without any coordination
    state beyond the weight vector itself.
    """
    weights = np.asarray(weights, np.float64)
    V = weights.shape[0]
    place = np.zeros(V, np.int32)
    if n_shards <= 1:
        return place
    rng = np.random.default_rng(seed)
    c0 = rng.integers(0, n_shards, size=V)
    c1 = (c0 + 1 + rng.integers(0, n_shards - 1, size=V)) % n_shards
    load = np.zeros(n_shards, np.float64)
    for v in np.argsort(-weights, kind="stable"):
        a, b = c0[v], c1[v]
        s = a if load[a] <= load[b] else b
        place[v] = s
        load[s] += weights[v]
    return place


@dataclasses.dataclass(frozen=True)
class VirtualLayout:
    """Frozen key -> (shard, row) map plus its inverse.

    Shapes: E = user-visible entity count, V = n_virtual,
    R = n_shards * entities_per_shard (>= E; padding rows carry the
    sentinel ``E`` in ``gid_of_row``).
    """
    n_shards: int
    n_virtual: int
    entities_per_shard: int
    place: np.ndarray         # int32 [V] physical shard of each virtual shard
    shard_of_key: np.ndarray  # int32 [E]
    local_of_key: np.ndarray  # int32 [E] row within the owning shard
    gid_of_row: np.ndarray    # int32 [R] global key of each flat state row

    @property
    def num_rows(self) -> int:
        return self.n_shards * self.entities_per_shard

    @property
    def row_of_key(self) -> np.ndarray:
        """Flat state row of each key (the materialize-time gather map)."""
        return (self.shard_of_key.astype(np.int64)
                * self.entities_per_shard
                + self.local_of_key).astype(np.int32)


def build_layout(num_entities: int, n_shards: int,
                 key_weights: Optional[np.ndarray] = None,
                 n_virtual: Optional[int] = None,
                 seed: int = 0) -> VirtualLayout:
    """Build the frozen virtual-shard layout for ``num_entities`` keys.

    ``key_weights`` is the observed per-key volume (e.g. ``np.bincount`` of
    a representative stream); ``None`` balances key *count* instead, which
    only helps when skew is mild.  The layout is frozen at construction —
    state rows never move while an engine is live (re-balancing on fresher
    weights means building a new engine + re-keyed state, i.e. the elastic
    resharding path).
    """
    E, n = int(num_entities), int(n_shards)
    V = int(n_virtual) if n_virtual else max(n * DEFAULT_VIRTUAL_FACTOR, 1)
    if key_weights is None:
        kw = np.ones(E, np.float64)
    else:
        kw = np.asarray(key_weights, np.float64)
        if kw.shape[0] < E:          # sparse observation: pad cold keys
            kw = np.pad(kw, (0, E - kw.shape[0]))
        kw = kw[:E]
    v_of_key = virtual_shard_of(np.arange(E), V)
    w_virtual = np.bincount(v_of_key, weights=kw, minlength=V)
    place = place_virtual_shards(w_virtual, n, seed)
    shard_of_key = place[v_of_key].astype(np.int32)
    counts = np.bincount(shard_of_key, minlength=n)
    entities_per_shard = max(1, int(counts.max()))
    # local row = rank of the key among its shard's keys, ascending key order
    order = np.argsort(shard_of_key, kind="stable")
    starts = np.cumsum(counts) - counts
    local = np.empty(E, np.int64)
    local[order] = np.arange(E) - starts[shard_of_key[order]]
    gid = np.full(n * entities_per_shard, E, np.int32)
    rows = shard_of_key.astype(np.int64) * entities_per_shard + local
    gid[rows] = np.arange(E, dtype=np.int32)
    return VirtualLayout(n_shards=n, n_virtual=V,
                         entities_per_shard=entities_per_shard,
                         place=place, shard_of_key=shard_of_key,
                         local_of_key=local.astype(np.int32),
                         gid_of_row=gid)
