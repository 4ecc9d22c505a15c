"""repro_torch's checkpoints: round trip and GC, restart past a corrupt
latest, torn writes, elastic repartitioning — the twin of
``tests/test_checkpoint.py`` on the CPU — and the on-disk format shared
with the JAX package: a checkpoint written by either package restores in
the other, with the same manifest and byte-identical leaf files."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.core as jcore                                   # noqa: E402
from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.checkpoint import \
    repartition_profile_state as jax_repartition             # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,       # noqa: E402
                                    repartition_profile_state)
from repro_torch.core import (EngineConfig, Event, init_state,  # noqa: E402
                              make_step, prng_key, state_from_numpy)


def _tree_eq(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_eq(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _tree_eq(x, y)
    else:
        assert isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def _plus(tree, c):
    if isinstance(tree, dict):
        return {k: _plus(v, c) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_plus(v, c) for v in tree)
    return tree + c


def test_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_io=True)
    state = {"a": torch.arange(10, dtype=torch.float32),
             "b": (torch.ones((3, 4)), torch.zeros((), dtype=torch.int32))}
    for step in [1, 2, 3, 4]:
        mgr.save(step, _plus(state, step))
    mgr.wait()
    assert mgr.steps() == [3, 4]          # GC kept last 2
    got = mgr.restore(state)
    _tree_eq(got, _plus(state, 4))
    got3 = mgr.restore(state, step=3)
    _tree_eq(got3, _plus(state, 3))


def test_restart_skips_corrupt_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5, async_io=False)
    state = {"w": torch.arange(6, dtype=torch.float32)}
    mgr.save(1, state)
    mgr.save(2, {"w": state["w"] * 2})
    # corrupt the newest checkpoint's data file
    d = os.path.join(str(tmp_path), "step_000000002")
    with open(os.path.join(d, "arr_00000.npy"), "r+b") as f:
        f.seek(64)
        f.write(b"\xff" * 8)
    got = mgr.restore(state)              # falls back to step 1
    _tree_eq(got, state)


def test_torn_write_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5, async_io=False)
    state = {"w": torch.ones(4)}
    mgr.save(7, state)
    # a crash mid-save leaves only a .tmp directory
    os.makedirs(os.path.join(str(tmp_path), "step_000000009.tmp"))
    assert mgr.latest_step() == 7
    got = mgr.restore(state)
    _tree_eq(got, state)


def _stepped_state(old, num_keys=23):
    """A fast-mode profile state in the old_shards flat-row layout."""
    cfg = EngineConfig(taus=(60.0, 3600.0), h=600.0, budget=0.05,
                       exact_rounds=8)
    e_local_old = -(-num_keys // old)
    state = init_state(e_local_old * old, 2, device="cpu")
    rng = np.random.default_rng(0)
    step = make_step(cfg, "fast")
    root = prng_key(1)
    keys = rng.integers(0, num_keys, 64).astype(np.int64)
    qs = rng.lognormal(3, 1, 64).astype(np.float32)
    ts = np.sort(rng.uniform(0, 1e4, 64)).astype(np.float32)
    flat_old = (keys % old) * e_local_old + keys // old
    for i in range(0, 64, 8):
        ev = Event(key=torch.from_numpy(flat_old[i:i + 8]),
                   q=torch.from_numpy(qs[i:i + 8]),
                   t=torch.from_numpy(ts[i:i + 8]),
                   valid=torch.ones(8, dtype=torch.bool))
        state, _ = step(state, ev, root)
    return state


@pytest.mark.parametrize("old,new", [(1, 4), (4, 2), (2, 8), (8, 8)])
def test_elastic_repartition_preserves_semantics(old, new):
    """Grow/shrink the fleet; every key's profile row must move with it,
    onto the requested device, and the rows equal the JAX function's."""
    num_keys = 23
    state = _stepped_state(old, num_keys)
    new_state = repartition_profile_state(state, old_shards=old,
                                          new_shards=new, num_keys=num_keys,
                                          device="cpu")
    e_local_old = -(-num_keys // old)
    e_local_new = -(-num_keys // new)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in new_state)
    for k in range(num_keys):
        src = (k % old) * e_local_old + k // old
        dst = (k % new) * e_local_new + k // new
        for f in ("agg", "v_f", "last_t"):
            np.testing.assert_array_equal(getattr(state, f)[src].numpy(),
                                          getattr(new_state, f)[dst].numpy())
    want = jax_repartition(jcore.ProfileState(*(x.numpy() for x in state)),
                           old_shards=old, new_shards=new, num_keys=num_keys)
    for a, b in zip(new_state, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _manifest(root, step):
    with open(os.path.join(root, f"step_{step:09d}", "manifest.json")) as f:
        m = json.load(f)
    m.pop("time")
    return m


def _files(root, step):
    d = os.path.join(root, f"step_{step:09d}")
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".npy")}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A profile state plus a dict of arrays, saved by one package and
    restored by the other (and by itself): same manifest (treedef string,
    shapes, dtypes, hashes), byte-identical ``.npy`` files, bitwise
    leaves; a 1 -> 4 -> 1 repartition of the restored state is the
    identity on every key."""
    state = _stepped_state(1, 23)
    host = [x.numpy() for x in state]
    extra = {"step": np.int32(9), "w": np.arange(6, dtype=np.float32)}
    port_tree = {"profile": state, "aux": {k: torch.as_tensor(v)
                                           for k, v in extra.items()}}
    jax_tree = {"profile": jcore.ProfileState(*(jnp.asarray(x)
                                                for x in host)),
                "aux": {k: jnp.asarray(v) for k, v in extra.items()}}
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    CheckpointManager(a, async_io=False).save(3, port_tree, extra={"n": 1})
    JaxManager(b, async_io=False).save(3, jax_tree, extra={"n": 1})
    assert _manifest(a, 3) == _manifest(b, 3)
    assert _files(a, 3) == _files(b, 3)

    root = a if writer == "port" else b
    got = CheckpointManager(root).restore(port_tree, device="cpu")
    _tree_eq(got, port_tree)
    back = JaxManager(root).restore(jax_tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jax_tree)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    restored = got["profile"]
    grown = repartition_profile_state(restored, old_shards=1, new_shards=4,
                                      device="cpu")
    shrunk = repartition_profile_state(grown, old_shards=4, new_shards=1,
                                       num_keys=23, device="cpu")
    _tree_eq(tuple(shrunk), tuple(state_from_numpy(*host, device="cpu")))
