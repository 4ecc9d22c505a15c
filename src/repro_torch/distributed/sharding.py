"""Logical-axis -> mesh-axis rule tables (DP / FSDP / TP / EP / SP), the
PyTorch port of ``repro.distributed.sharding``.

A rule maps a logical axis name to a *preference list* of mesh-axis tuples;
``context.pspec_for`` walks the list and picks the first candidate that (a)
divides the dimension and (b) does not reuse a mesh axis already consumed by
an earlier dimension of the same tensor.  This gives per-arch divisibility
fallbacks (smollm's 15 heads -> replicate; command-r's kv=8 -> shard head_dim
instead) without per-arch special cases.  ``context.placements_for`` turns
the chosen mesh axes into DTensor placements on a ``DeviceMesh``.

Axes glossary
  batch     activation batch / token dim              -> DP over (pod, data)
  entities  feature-store entity partition dim        -> DP over (pod, data)
  embed     weight d_model dim                        -> FSDP over data
  vocab     vocabulary dim of embed table / lm head   -> TP over model
  heads / kv_heads / head_dim / ff                    -> TP over model
  experts   MoE expert dim                            -> EP over model
  seq       sequence dim (sequence parallelism)       -> SP over model (opt-in)

A mesh here is a ``torch.distributed`` ``DeviceMesh``: its
``mesh_dim_names`` are the axis names and ``mesh.shape`` their sizes (any
object with ``axis_names`` and ``devices.shape``, as a JAX mesh has, is
read too).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

Rules = Dict[str, List[Tuple[str, ...]]]

# Baseline rule table used by the launcher for every arch; per-arch
# overrides merge on top.
DEFAULT_RULES: Rules = {
    # data-parallel dims
    "batch": [("pod", "data"), ("data",), ()],
    "entities": [("pod", "data"), ("data",), ()],
    # tensor-parallel dims
    "vocab": [("model",), ()],
    "heads": [("model",), ()],
    "kv_heads": [("model",), ()],
    "head_dim": [("model",), ()],
    "ff": [("model",), ()],
    "experts": [("model",), ()],
    # FSDP (ZeRO-3): weight d_model dims sharded over the data axis; DTensor
    # all-gathers weights per use and reduce-scatters grads.
    "embed": [("data",), ()],
    # sequence parallelism is opt-in (make_rules(seq_parallel=True))
    "seq": [()],
    # decode KV caches shard their sequence dim over 'model' (partial-softmax
    # decode) — independent of activation sequence parallelism
    "kv_seq": [("model",), ()],
    # decode-time q head sharding (separate from weight TP)
    "dec_heads": [("model",), ()],
    # MoE dispatch capacity dim: co-shard with the data axis so the [E, cap,
    # D] buffer doesn't blow up per-device memory at 1M-token batches.
    "capacity": [("data",), ()],
    # layer-stack dim is never sharded
    "layers": [()],
    # vision-token dim
    "vision": [()],
    # expert weights' d_model dim: no spec names it; kept so that the
    # table equals the reference's
    "expert_embed": [()],
}


def make_rules(*, fsdp: bool = True, seq_parallel: bool = False,
               expert_data_shard: bool = False,
               overrides: dict | None = None) -> Rules:
    """Build a rule table (the reference's options).

    fsdp: shard weight d_model dims over ('pod','data') / ('data',).
    seq_parallel: shard activation seq dims over 'model' (the residual
      stream between blocks: ``context.shard``).
    expert_data_shard: additionally shard expert weight d_model over data
      (no spec names ``expert_embed`` in either package, so this changes
      no placement; the table equals the reference's).
    """
    rules = {k: list(v) for k, v in DEFAULT_RULES.items()}
    if fsdp:
        rules["embed"] = [("pod", "data"), ("data",), ()]
    else:
        rules["embed"] = [()]
    if seq_parallel:
        rules["seq"] = [("model",), ()]
    if expert_data_shard:
        rules["expert_embed"] = [("pod", "data"), ("data",), ()]
    else:
        rules["expert_embed"] = [()]
    if overrides:
        for k, v in overrides.items():
            rules[k] = [tuple(c) for c in v]
    return rules


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of a JAX-like mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(n) for n in mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, (int(n) for n in mesh.devices.shape)))


def axis_sizes(mesh, axes) -> Tuple[int, ...]:
    """Sizes of the named mesh axes, in the given order."""
    sizes = mesh_sizes(mesh)
    return tuple(int(sizes[a]) for a in axes)


def data_axis_size(mesh) -> int:
    sizes = mesh_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def model_axis_size(mesh) -> int:
    return mesh_sizes(mesh).get("model", 1)
