"""Sharded, async, integrity-checked checkpointing with elastic restore
(PyTorch port of ``repro.checkpoint.manager``).

Layout (one directory per step):

    <root>/step_000000420.tmp/     # written here first
        manifest.json              # treedef, shapes, dtypes, hashes, step
        arr_00000.npy ...          # one file per leaf
    <root>/step_000000420/         # atomic rename on completion

Durability contract: a checkpoint is valid iff the rename happened AND every
leaf hash in the manifest verifies — torn writes (node failure mid-save)
leave only a .tmp directory, which restore ignores and GC removes.  This is
the single-host realization of the per-host-shard-files + manifest design in
DESIGN.md §6; on a real pod each host writes its own address slice and the
manifest unions them.

Async: ``save(...)`` snapshots to host memory synchronously (cheap) and does
file IO on a background thread, overlapping with the next training step —
``wait()`` joins before the next save or at exit.

Elastic restore: profile-store states saved under one shard count can be
re-partitioned to another (``elastic.repartition_profile_state``).

Sharded states (``save``/``restore`` with ``mesh=``, the sharded feature
engine's per-rank rows): ``save`` gathers every tensor leaf's rows to
rank 0 in rank order — the flat ``shard * E_local + local`` order of the
JAX engine's global arrays (``distributed.collectives.gather_rows``) —
and rank 0 alone writes the full logical arrays, so the directory is the
one the JAX package writes for its sharded state.  ``restore`` onto a
mesh reads on rank 0 alone and scatters each rank its rows.

The on-disk format is the JAX package's, byte for byte in every file but
the manifest's ``time``: leaves are flattened in JAX's order (dict keys
sorted, tuples, lists and NamedTuples in field order, ``None`` holds no
leaf), saved as ``.npy`` host arrays, hashed and described by the same
manifest (its ``treedef`` string written in JAX's notation), so a
checkpoint written by either package restores in the other.  Tensors are
copied to the host with ``.cpu().numpy()`` at save and restored with
``torch.as_tensor(..., device=)`` onto the template leaf's device (or the
``device`` passed to ``restore``).  A bfloat16 leaf is written as its raw
two-byte values (numpy has no bfloat16; the file holds what numpy writes
for JAX's ``ml_dtypes`` bfloat16 arrays, a ``|V2`` array of the same
bytes) with ``bfloat16`` in the manifest, and read back bit for bit.

A training state (``train.trainer.TrainState``: NamedTuples holding
``None`` where there is no master copy or sync state, the parameters'
group stacks as tuples) is one such tree: ``save(step, state)`` and
``restore(template)`` with a state of the same configuration as the
template; ``train.trainer.restore_train_state`` makes the restored
parameters trainable again.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves`` in JAX's flatten order and
    return its structure in JAX's ``PyTreeDef`` notation."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in keys) + "}"
    if _is_namedtuple(tree):
        inner = ", ".join(_flatten(x, leaves) for x in tree)
        return (f"CustomNode(namedtuple[{type(tree).__name__}], "
                f"[{inner}])")
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_flatten(x, leaves) for x in tree)
        if isinstance(tree, list):
            return f"[{inner}]"
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    leaves.append(tree)
    return "*"


def _unflatten(template, it):
    """``template``'s structure with its leaves taken from ``it``."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], it) for k in sorted(template)}
        return type(template)((k, out[k]) for k in template)
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(x, it) for x in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(x, it) for x in template)
    return next(it)


def _tree_paths(tree):
    leaves: list = []
    treedef = f"PyTreeDef({_flatten(tree, leaves)})"
    return leaves, treedef


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:    # raw 2-byte values, as |V2
            return x.detach().cpu().view(torch.int16).numpy().view("V2")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _from_host(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    """A loaded array as a tensor of ``like``'s dtype on ``device``."""
    if arr.dtype == np.dtype("V2"):          # bfloat16 bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.as_tensor(arr)
    return t.to(device=device, dtype=like.dtype)


def _hash(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


@dataclasses.dataclass
class CheckpointManager:
    root: str
    keep: int = 3                       # retained checkpoints (GC)
    async_io: bool = True

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, *, extra: Optional[dict] = None,
             mesh=None) -> None:
        """Snapshot now, write in background (if async_io).

        ``mesh``: ``state`` is this rank's shard of a sharded state (every
        tensor leaf split along its first dim); a collective — every rank
        calls it, rank 0 gathers the full arrays and writes them, the
        others return once their rows are sent.
        """
        if mesh is not None:
            from repro_torch.distributed.collectives import gather_rows
            from repro_torch.launch.mesh import shard_of_mesh

            _, shard, group = shard_of_mesh(mesh)
            leaves, _ = _tree_paths(state)
            full = [gather_rows(x, group) if isinstance(x, torch.Tensor)
                    else x for x in leaves]
            if shard != 0:
                return
            state = _unflatten(state, iter(full))
        self.wait()
        leaves, treedef = _tree_paths(state)
        host = [_to_host(x) for x in leaves]
        treedef_str = treedef

        def _write():
            tmp = os.path.join(self.root, f"step_{step:09d}.tmp")
            final = os.path.join(self.root, f"step_{step:09d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {
                "step": step,
                "treedef": treedef_str,
                "extra": extra or {},
                "leaves": [],
                "time": time.time(),
            }
            for i, arr in enumerate(host):
                name = f"arr_{i:05d}.npy"
                np.save(os.path.join(tmp, name), arr)
                manifest["leaves"].append({
                    "file": name, "shape": list(arr.shape),
                    "dtype": _dtype_name(arr), "sha": _hash(arr)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, final) if not os.path.exists(final) else None
            if os.path.exists(tmp):          # final existed: overwrite
                shutil.rmtree(final)
                os.rename(tmp, final)
            self._gc()

        if self.async_io:
            self._pending = self._pool.submit(_write)
        else:
            _write()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # ---------------------------------------------------------- restore
    def steps(self) -> list:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, d,
                                               "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: Optional[int] = None,
                *, verify: bool = True, device=None, mesh=None) -> Any:
        """Restore into the structure of ``template`` (shapes must match).

        Tensor leaves of ``template`` come back as tensors of the
        template's dtype on ``device`` (default: the template leaf's own
        device); other leaves come back as host arrays.  Walks back
        through older checkpoints if the newest is corrupt —
        restart-from-latest-valid is the node-failure recovery path.

        ``mesh``: ``template`` is this rank's shard (as for ``save``); a
        collective — rank 0 reads the full arrays (each ``n`` times the
        template's rows) and every rank gets its rows, the other leaves
        as rank 0 read them.  A failure on rank 0 raises on every rank.
        """
        if mesh is not None:
            return self._restore_sharded(template, step, verify, device,
                                         mesh)
        self.wait()
        candidates = self.steps()[::-1] if step is None else [step]
        last_err: Optional[Exception] = None
        for s in candidates:
            try:
                return self._restore_one(template, s, verify, device)
            except Exception as e:          # corrupt -> try older
                last_err = e
                continue
        raise FileNotFoundError(
            f"no valid checkpoint under {self.root}: {last_err}")

    def _restore_sharded(self, template, step, verify, device, mesh):
        from repro_torch.distributed import collectives
        from repro_torch.launch.mesh import shard_of_mesh

        n, shard, group = shard_of_mesh(mesh)
        leaves, _ = _tree_paths(template)
        host = err = None
        if shard == 0:
            full = [torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                                dtype=x.dtype)
                    if isinstance(x, torch.Tensor) else x for x in leaves]
            try:
                got, _ = _tree_paths(self.restore(
                    _unflatten(template, iter(full)), step, verify=verify,
                    device="cpu"))
                host = [x.numpy() if isinstance(x, torch.Tensor) else x
                        for x in got]
            except Exception as e:           # raised on every rank below
                err = f"{type(e).__name__}: {e}"
        others = collectives.broadcast_object(
            (err, None if host is None else
             [None if isinstance(t, torch.Tensor) else h
              for t, h in zip(leaves, host)]), group)
        if others[0] is not None:
            raise FileNotFoundError(f"sharded restore on rank 0 failed: "
                                    f"{others[0]}")
        out = []
        for i, t in enumerate(leaves):
            if isinstance(t, torch.Tensor):
                like = torch.empty_like(t, device=device or t.device)
                out.append(collectives.scatter_rows(
                    None if host is None else host[i], like, group))
            else:
                out.append(others[1][i])
        return _unflatten(template, iter(out))

    def _restore_one(self, template, step: int, verify: bool, device):
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, treedef = _tree_paths(template)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError("tree structure changed between save and "
                             "restore")
        out = []
        for t, meta in zip(leaves, manifest["leaves"]):
            arr = np.load(os.path.join(d, meta["file"]))
            if verify and _hash(arr) != meta["sha"]:
                raise IOError(f"hash mismatch in {meta['file']}")
            if isinstance(t, torch.Tensor):
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"{meta['file']}: shape {arr.shape} "
                                     f"!= template {tuple(t.shape)}")
                arr = _from_host(arr, t, t.device if device is None
                                 else device)
            out.append(arr)
        return _unflatten(template, iter(out))

    def restore_manifest(self, step: int) -> dict:
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)

    # --------------------------------------------------------------- gc
    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)
        for d in os.listdir(self.root):
            if d.endswith(".tmp"):
                full = os.path.join(self.root, d)
                if time.time() - os.path.getmtime(full) > 3600:
                    shutil.rmtree(full, ignore_errors=True)
