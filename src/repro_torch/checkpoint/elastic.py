"""Elastic re-scaling of checkpointed state across shard counts (PyTorch).

The counterpart of ``repro.checkpoint.elastic``.  The *profile store*'s
row layout encodes the shard count (key k lives at flat row
(k % n) * E_local + (k // n)), so growing or shrinking the worker fleet
must re-permute rows.  That permutation is what
``repartition_profile_state`` computes; it is the mesh-form of the paper's
observation that only *persisted* state is migrated during rebalancing
(§4: "aligns with the execution model of modern streaming engines").
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import _to_host
from repro_torch.core.types import ProfileState, resolve_device


def _flat_row(keys: np.ndarray, n_shards: int, e_local: int) -> np.ndarray:
    return (keys % n_shards) * e_local + keys // n_shards


def repartition_profile_state(state: Optional[ProfileState], *,
                              old_shards: int, new_shards: int,
                              num_keys: Optional[int] = None,
                              device=None, mesh=None) -> ProfileState:
    """Re-permute a profile store from old_shards to new_shards layout.

    Works on host arrays (restore-time operation; ``state`` may hold
    tensors on any device or host arrays) and returns the port's
    ``ProfileState`` on ``device`` (``cuda:0`` unless named).  The output
    is sized for the new fleet: E_local_new = ceil(num_keys / new_shards),
    padded rows fresh-initialized.

    ``mesh``: a ``new_shards``-rank mesh; a collective.  ``state`` is the
    full logical state on rank 0 (the others pass ``None``; it is what
    ``CheckpointManager.restore`` gives without a mesh), rank 0 re-permutes
    it and every rank gets its ``E_local_new`` rows, on ``device``
    (default: the mesh's device type, the rank's own card).
    """
    if mesh is not None:
        return _repartition_onto(state, old_shards, new_shards, num_keys,
                                 device, mesh)
    dev = resolve_device(device)
    total_old = state.last_t.shape[0]
    e_local_old = total_old // old_shards
    num_keys = num_keys or total_old
    e_local_new = -(-num_keys // new_shards)
    total_new = e_local_new * new_shards

    keys = np.arange(num_keys)
    src = _flat_row(keys, old_shards, e_local_old)
    dst = _flat_row(keys, new_shards, e_local_new)

    def move(arr, fill):
        arr = _to_host(arr)
        out = np.full((total_new,) + arr.shape[1:], fill, arr.dtype)
        out[dst] = arr[src]
        return torch.as_tensor(out, device=dev)

    return ProfileState(
        last_t=move(state.last_t, -np.inf),
        v_f=move(state.v_f, 0.0),
        agg=move(state.agg, 0.0),
        v_full=move(state.v_full, 0.0),
        last_t_full=move(state.last_t_full, -np.inf),
    )


def _repartition_onto(state, old_shards, new_shards, num_keys, device,
                      mesh) -> ProfileState:
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import shard_of_mesh

    n, shard, group = shard_of_mesh(mesh)
    if n != new_shards:
        raise ValueError(f"a {n}-rank mesh cannot take {new_shards} shards")
    dev = resolve_device(mesh.device_type if device is None else device)
    full = None
    if shard == 0:
        full = repartition_profile_state(state, old_shards=old_shards,
                                         new_shards=new_shards,
                                         num_keys=num_keys, device="cpu")
    meta = collectives.broadcast_object(
        None if full is None else [(tuple(x.shape), x.dtype) for x in full],
        group)
    return ProfileState(*(
        collectives.scatter_rows(
            None if full is None else x.numpy(),
            torch.empty((shape[0] // n,) + shape[1:], dtype=dt, device=dev),
            group)
        for x, (shape, dt) in zip(full or [None] * len(meta), meta)))
