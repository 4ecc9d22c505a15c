"""Process-global mesh context (PyTorch): the mesh half of
``repro.distributed.context``.

The launcher installs a ``torch.distributed`` ``DeviceMesh``
(``launch.mesh.make_model_mesh``) and model code that shards its work
reads it: ``models.moe_ep`` spreads the experts over the mesh's
``"model"`` dim, as the JAX ``moe_ep`` reads the JAX mesh.  Outside a mesh
context ``get_mesh()`` is None and that code runs on one device.  The
context is per thread, as the reference's.  The sharding-rule half of the
reference (logical axis names to mesh axes) is not ported.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

__all__ = ["set_mesh", "get_mesh", "mesh_context"]

_STATE = threading.local()


def set_mesh(mesh: Optional[DeviceMesh]) -> None:
    _STATE.mesh = mesh


def get_mesh() -> Optional[DeviceMesh]:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh):
    """Install ``mesh`` for the block; the previous one comes back after."""
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)
