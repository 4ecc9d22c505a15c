"""repro_torch's sharded feature engine: n gloo ranks on the CPU, one
process a shard (``distributed.spawn.run_ranks``), held against the
single-device JAX engine run in the test process.

The ranks import no JAX: they unpickle this module's rank functions, so
the module imports JAX only inside the tests (the ``jx`` fixture).  Every
spawn is bounded by ``run_ranks``' timeout (``TIMEOUT_S``); one spawn of
four ranks (``suite``) runs every mirrored mesh case and the tests below
read its results (the spawn runs in two parts, each well inside the
timeout).

Bounds, with their reasons:

* Exact mode (``run_stream``, the sink, hydration, residency,
  checkpoints): bitwise — z, p, writes, the state after the layout's row
  permutation, store bytes.  Exact mode is batching-invariant, so the
  sharded blocks equal the local engine's stream.
* The per-micro-batch step against the op-by-op JAX step from the same
  state: z and p bitwise, features within 1e-6 (the JAX mesh test's
  bounds); the exact state bitwise, the fast state within rtol 1e-6 (the
  port's fold rounds ``exp`` and the segment sums apart from XLA's,
  ``test_torch_engine.py``).  Against the port's one-card engine fed the
  same routed blocks with global keys, the fast step is bitwise.
* ``materialize``: bitwise against the one-card port engine on the same
  rows, within rtol 1e-6 of JAX's (``test_torch_engine.py``); the std
  feature, ``sqrt(m2 - mean^2)``, cancels, so it is held through its
  square within 1e-6 of ``m2``.
* Scores: the sharded pipeline's features are bitwise those of the
  single-shard pipeline; scores within rtol 1e-5 (the ranks run on one
  thread, the test process may not).
"""
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    repartition_profile_state)
from repro_torch.core import (EngineConfig, Event, init_state,  # noqa: E402
                              make_step, materialize_features, prng_key,
                              state_from_numpy)
from repro_torch.distributed import rebalance                # noqa: E402
from repro_torch.distributed.spawn import RankFailed, run_ranks  # noqa: E402
from repro_torch.features.engine import (ShardedFeatureEngine,  # noqa: E402
                                         route_stream_blocks)
from repro_torch.features.spec import ProfileSpec            # noqa: E402
from repro_torch.launch.mesh import shard_of_mesh           # noqa: E402
from repro_torch.serving import pipeline                     # noqa: E402
from repro_torch.streaming.durable import (DurableStore,     # noqa: E402
                                           PartitionLockedError)
from repro_torch.streaming.persistence import WriteBehindSink  # noqa: E402
from repro_torch.streaming.residency import ResidencyMap     # noqa: E402

N_RANKS = 4
TIMEOUT_S = 60.0
E = 64
SEED = 5
ROOT = prng_key(SEED)
CFG = dict(taus=(60.0, 3600.0), h=600.0, policy="pp")
FIELDS = ("last_t", "v_f", "agg", "v_full", "last_t_full")
SPEC = dict(windows=(60.0, 3600.0), kde_bandwidth=600.0,
            write_budget_per_min=0.12, policy="pp_vr", variance_alpha=1.0)


# ---------------------------------------------------------------- data
def _uniform(n_events=1500, n_keys=E, seed=1):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n_events).astype(np.int32)
    qs = rng.lognormal(3, 1, n_events).astype(np.float32)
    ts = np.sort(rng.uniform(0, 2e5, n_events)).astype(np.float32)
    return keys, qs, ts


def _extreme_skew(n_events=1500, n_keys=E, hot=37, seed=1):
    """One key carries ~85 % of the events (the JAX virtual-layout
    test's stream)."""
    rng = np.random.default_rng(seed)
    keys = np.where(rng.uniform(size=n_events) < 0.85, hot,
                    rng.integers(0, n_keys, n_events)).astype(np.int32)
    qs = rng.lognormal(3, 1, n_events).astype(np.float32)
    ts = np.sort(rng.uniform(0, 2e5, n_events)).astype(np.float32)
    return keys, qs, ts


def _zipf(n_events, n_keys, skew, seed, gap=20.0):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_keys + 1) ** skew
    keys = rng.choice(n_keys, n_events, p=w / w.sum()).astype(np.int32)
    ts = np.cumsum(rng.exponential(gap, n_events)).astype(np.float32)
    qs = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    return keys, qs, ts


def _shard_of_key(layout, keys, n, n_keys=E):
    if layout == "virtual":
        lay = rebalance.build_layout(
            n_keys, n, key_weights=np.bincount(keys, minlength=n_keys))
        return np.asarray(lay.shard_of_key)
    return np.arange(n_keys) % n


def _rounds(keys, *, n, batch_per_shard, layout="block", local_batch=None,
            n_keys=E):
    """The most events of one key in one shard's block (and in one local
    block of ``local_batch``): the exact mode's ``exact_rounds``, measured,
    so neither engine drops an event."""
    shard = _shard_of_key(layout, keys, n, n_keys)[keys]
    packed, _, _, valid, _, n_blocks = route_stream_blocks(
        shard, keys, keys, keys, n, batch_per_shard)
    blk = np.repeat(np.arange(n_blocks), n * batch_per_shard)
    r = int(np.unique(blk[valid] * n_keys + packed[valid],
                      return_counts=True)[1].max())
    if local_batch:
        r = max(r, max(int(np.bincount(keys[i:i + local_batch]).max())
                       for i in range(0, len(keys), local_batch)))
    return r


def _perm(layout, keys, n, n_keys=E):
    """Flat sharded row of each global entity (``shard * E_local +
    local``)."""
    if layout == "virtual":
        return np.asarray(rebalance.build_layout(
            n_keys, n, key_weights=np.bincount(keys, minlength=n_keys))
            .row_of_key, np.int64)
    k = np.arange(n_keys)
    e_local = -(-n_keys // n)
    return (k % n) * e_local + k // n


def _np_state(st):
    return [x.numpy().copy() for x in st]


def _full(ranks, key="state"):
    """Ranks' local states concatenated in rank order (the flat sharded
    layout)."""
    return [np.concatenate([r[key][i] for r in ranks]) for i in range(5)]


# ------------------------------------------------------- rank functions
def _exact_runs(mesh, d):
    """Exact ``run_stream`` for each layout; the block layout also with
    ``collect_info=False`` (the per-block write counts)."""
    out = {}
    for layout, (keys, qs, ts), B, rounds in d["exact"]:
        cfg = EngineConfig(**CFG, budget=0.0005, exact_rounds=rounds)
        kw = dict(mode="exact", layout=layout,
                  key_weights=np.bincount(keys, minlength=E))
        eng = ShardedFeatureEngine(cfg, E, mesh=mesh, **kw)
        st, info = eng.run_stream(eng.init_state(), keys, qs, ts,
                                  batch_per_shard=B, rng=ROOT)
        out[layout] = dict(state=_np_state(st),
                           **{f: getattr(info, f).numpy() for f in
                              ("z", "p", "lam_hat", "features", "writes")})
        if layout == "block":
            _, wr = eng.run_stream(eng.init_state(), keys, qs, ts,
                                   batch_per_shard=B, rng=ROOT,
                                   collect_info=False)
            out[layout]["writes_blocks"] = wr.numpy()
    return out


def _layout_stats(mesh, d):
    """``stream_layout_stats`` of a Zipf stream, each layout."""
    keys, n_keys = d["padding"], 128
    return {lay: ShardedFeatureEngine(
        EngineConfig(**CFG, budget=0.0005), n_keys, mesh=mesh, layout=lay,
        key_weights=np.bincount(keys, minlength=n_keys)).stream_layout_stats(
            keys, 16) for lay in ("block", "virtual")}


def _two_dim_run(mesh, d):
    """The block layout on a 2 x 2 mesh with data axes ("pod", "data")."""
    from torch.distributed.device_mesh import DeviceMesh
    mesh2 = DeviceMesh("cpu", torch.arange(N_RANKS).reshape(2, 2),
                       mesh_dim_names=("pod", "data"))
    layout, (keys, qs, ts), B, rounds = d["exact"][0]
    cfg = EngineConfig(**CFG, budget=0.0005, exact_rounds=rounds)
    eng = ShardedFeatureEngine(cfg, E, mesh=mesh2, mode="exact",
                               data_axes=("pod", "data"))
    st, info = eng.run_stream(eng.init_state(), keys, qs, ts,
                              batch_per_shard=B, rng=ROOT)
    return dict(shard=eng.shard, state=_np_state(st), z=info.z.numpy())


NESTED = {"pod2": (2, 1, 2), "data2": (1, 2, 2)}   # ("pod", "data", "model")


def _nested_runs(mesh, d):
    """Data axes ("pod", "data") inside a ("pod", "data", "model") mesh of
    4 ranks: two shards, each held by the two ranks of a "model" row.
    Exact ``run_stream`` in each layout on each mesh shape."""
    from torch.distributed.device_mesh import DeviceMesh
    out = {}
    for name, shape in NESTED.items():
        mesh3 = DeviceMesh("cpu", torch.arange(N_RANKS).reshape(shape),
                           mesh_dim_names=("pod", "data", "model"))
        for layout, (keys, qs, ts), B, rounds in d["nested"]:
            cfg = EngineConfig(**CFG, budget=0.0005, exact_rounds=rounds)
            eng = ShardedFeatureEngine(
                cfg, E, mesh=mesh3, mode="exact", layout=layout,
                data_axes=("pod", "data"),
                key_weights=np.bincount(keys, minlength=E))
            st, info = eng.run_stream(eng.init_state(), keys, qs, ts,
                                      batch_per_shard=B, rng=ROOT)
            out[name, layout] = dict(
                n=eng.n_shards, shard=eng.shard, state=_np_state(st),
                **{f: getattr(info, f).numpy() for f in
                   ("z", "p", "lam_hat", "writes")})
        first = shard_of_mesh(mesh3, ("pod", "data"))
        again = shard_of_mesh(mesh3, ("pod", "data"))
        out[name, "cached"] = first[2] is again[2] and first[:2] == again[:2]
    # a coset whose shard order is not its global-rank order is refused
    flipped = DeviceMesh("cpu", torch.arange(N_RANKS).flip(0).reshape(
        NESTED["pod2"]), mesh_dim_names=("pod", "data", "model"))
    try:
        shard_of_mesh(flipped, ("pod", "data"))
        out["flipped"] = None
    except ValueError as e:
        out["flipped"] = str(e)
    return out


def _micro_steps(mesh, d):
    """``partition_events`` + ``make_step`` per micro-batch, both modes."""
    keys, qs, ts = d["steps"]
    out = {}
    for mode in ("exact", "fast"):
        cfg = EngineConfig(**CFG, budget=0.0005, exact_rounds=16)
        eng = ShardedFeatureEngine(cfg, E, mesh=mesh, mode=mode)
        st, step = eng.init_state(), eng.make_step()
        rec = []
        for i in range(0, len(keys), 64):
            ev = eng.partition_events(keys[i:i + 64], qs[i:i + 64],
                                      ts[i:i + 64], 16)
            before = _np_state(st)
            st, info = step(st, ev, ROOT)
            rec.append(dict(
                before=before, key=ev.key.numpy(), q=ev.q.numpy(),
                t=ev.t.numpy(), valid=ev.valid.numpy(),
                **{f: getattr(info, f).numpy() for f in
                   ("z", "p", "lam_hat", "features", "writes")}))
        out[mode] = dict(steps=rec, state=_np_state(st))
    return out


def _sink_runs(mesh, d):
    """Exact runs through the durable sink, then hydration (from the live
    stores and from the directory), ``materialize`` and
    ``materialize_cold``."""
    keys, qs, ts = d["worker"]
    out = {}
    for layout in ("block", "virtual"):
        cfg = EngineConfig(**CFG, budget=0.002, exact_rounds=d["w_rounds"])
        eng = ShardedFeatureEngine(
            cfg, E, mesh=mesh, mode="exact", layout=layout,
            key_weights=np.bincount(keys, minlength=E))
        store_dir = os.path.join(d["dir"], f"sink-{layout}")
        sink = eng.make_sink(backend="durable", store_dir=store_dir)
        st, info = eng.run_stream(eng.init_state(), keys, qs, ts,
                                  batch_per_shard=32, rng=ROOT, sink=sink,
                                  sink_group=3)
        sink.flush()
        foreign = int(np.nonzero(eng.route(np.arange(E))[0]
                                 != eng.shard)[0][0])
        try:
            sink.submit_read(np.array([foreign]))
            refused = False
        except ValueError:
            refused = True
        hyd = eng.hydrate_state(sink.stores)
        data = dict(sink.stores[0].data)
        sink.close()
        t_s = float(ts[-1]) + 1.0
        warm = eng.materialize(st, np.arange(E), t_s)
        stores = eng.reopen_stores(store_dir)
        cold = eng.materialize_cold(stores, np.arange(E), t_s)
        for s in stores:
            s.close()
        out[layout] = dict(
            state=_np_state(st), hydrated=_np_state(hyd),
            from_dir=_np_state(eng.hydrate_from_dir(store_dir)),
            bytes=data, z=info.z.numpy(), writes=int(info.writes),
            warm=warm.numpy(), cold=cold.numpy(), refused=refused,
            part=os.path.basename(sink.stores[0].path))
    return out


def _residency_runs(mesh, d):
    """Dense, resident (serial) and resident at depth 2, virtual layout,
    all through a sink: outputs and store bytes."""
    keys, qs, ts = d["zipf"]
    n_keys, S = d["zipf_keys"], 8
    out = {}
    for mode in ("exact", "fast"):
        cfg = EngineConfig(**CFG, budget=0.002, alpha=1.0, mu_tau_index=1,
                           exact_rounds=d["z_rounds"])
        runs = {}
        for name, res, depth in (("dense", None, 1), ("serial", S, 1),
                                 ("depth2", S, 2)):
            eng = ShardedFeatureEngine(
                cfg, n_keys, mesh=mesh, mode=mode, layout="virtual",
                key_weights=np.bincount(keys, minlength=n_keys))
            sink = eng.make_sink()
            maps = None
            if res is not None:
                maps = [ResidencyMap(eng.num_entities, S)
                        for _ in range(eng.n_shards)]
            st0 = eng.init_state() if res is None \
                else eng.init_resident_state(S)
            _, info = eng.run_stream(st0, keys, qs, ts, batch_per_shard=32,
                                     rng=ROOT, sink=sink, residency=maps,
                                     sink_group=2, pipeline_depth=depth)
            sink.flush()
            runs[name] = dict(
                touched=int(np.unique(
                    keys[eng.route(keys)[0] == eng.shard]).size),
                z=info.z.numpy(), p=info.p.numpy(),
                features=info.features.numpy(), writes=int(info.writes),
                bytes=dict(sink.stores[0].data),
                stats=None if maps is None
                else maps[eng.shard].stats.snapshot())
            sink.close()
        out[mode] = runs
    return out


def _checkpoints(mesh, d):
    """Save (a)'s 4-shard block state; restore it, and a JAX-written
    checkpoint, onto the mesh."""
    layout, (keys, qs, ts), B, rounds = d["exact"][0]
    cfg = EngineConfig(**CFG, budget=0.0005, exact_rounds=rounds)
    eng = ShardedFeatureEngine(cfg, E, mesh=mesh, mode="exact")
    st, _ = eng.run_stream(eng.init_state(), keys, qs, ts,
                           batch_per_shard=B, rng=ROOT)
    mgr = CheckpointManager(d["ckpt"], async_io=False)
    mgr.save(3, st, mesh=mesh)
    back = mgr.restore(eng.init_state(), mesh=mesh)
    jax_back = CheckpointManager(d["jax_ckpt"], async_io=False).restore(
        eng.init_state(), mesh=mesh)
    return dict(state=_np_state(st), back=_np_state(back),
                jax_back=_np_state(jax_back))


def _pipeline_runs(mesh, d):
    """``ScoringPipeline.build(mesh=)``: process_stream + score, then the
    restarts (from the sink, from the directory, the demo)."""
    keys, qs, ts = d["worker"]
    spec = ProfileSpec(**SPEC)
    pipe = pipeline.ScoringPipeline.build(spec, E, mesh=mesh, mode="exact",
                                          exact_rounds=d["w_rounds"])
    pipe.scorer = pipeline.init_scorer(torch.Generator().manual_seed(1),
                                       spec.feature_dim, device="cpu")
    store_dir = os.path.join(d["dir"], "pipe")
    sink = pipe.make_sink(backend="durable", store_dir=store_dir)
    st, info = pipe.process_stream(pipe.init(), keys, qs, ts, rng=ROOT,
                                   batch_per_shard=32, sink=sink)
    scores = pipeline.score(pipe.scorer, info.features)
    ents, t_s = np.unique(keys), float(ts[-1]) + 1.0
    live = pipeline.score(pipe.scorer, pipe.engine.materialize(st, ents,
                                                               t_s))
    rec = pipe.restart_from(sink)
    sink.close()
    rec_dir = pipe.restart_from_dir(store_dir)
    demo = pipeline.run_restart_demo(
        spec, E, keys, qs, ts, mode="exact", batch_per_shard=32, rng=ROOT,
        backend="durable", store_dir=os.path.join(d["dir"], "demo"),
        device="cpu", mesh=mesh, exact_rounds=d["w_rounds"])
    try:
        pipe.serve(keys, qs, ts)
        served = True
    except ValueError:
        served = False
    return dict(
        features=info.features.numpy(), z=info.z.numpy(),
        scores=scores.numpy(), live=live.numpy(),
        from_sink=pipeline.score(pipe.scorer, pipe.engine.materialize(
            rec, ents, t_s)).numpy(),
        from_dir=pipeline.score(pipe.scorer, pipe.engine.materialize(
            rec_dir, ents, t_s)).numpy(),
        demo_live=demo["scores_live"], demo_rec=demo["scores_recovered"],
        served=served)


def _suite(mesh, d, part):
    """The mirrored mesh cases on one set of ranks, in two parts (one
    spawn each, so each stays well inside its timeout)."""
    cases = {"engine": dict(exact=_exact_runs, two_dim=_two_dim_run,
                            nested=_nested_runs,
                            layout_stats=_layout_stats, steps=_micro_steps,
                            ckpt=_checkpoints),
             "storage": dict(sink=_sink_runs, residency=_residency_runs,
                             pipe=_pipeline_runs)}[part]
    out = {k: f(mesh, d) for k, f in cases.items()}
    return dict(out, shard=mesh.get_local_rank("data"),
                jax_loaded="jax" in sys.modules)


def _restore_on(mesh, d):
    """Rank 0 reads the 4-shard checkpoint; every rank gets its rows of
    the ``n``-shard layout."""
    full = None
    if mesh.get_local_rank("data") == 0:
        full = CheckpointManager(d["ckpt"], async_io=False).restore(
            init_state(E, 2, device="cpu"))
    st = repartition_profile_state(full, old_shards=N_RANKS,
                                   new_shards=mesh.size(), num_keys=E,
                                   mesh=mesh)
    return _np_state(st)


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here and not at module level: the ranks
    import this module."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.core as jcore
    from repro.checkpoint import (CheckpointManager as JaxCkpt,
                                  repartition_profile_state as jax_repart)
    from repro.core.stream import run_stream as jax_run_stream
    from repro.streaming.kvstore import KVStore as JaxKV
    from repro.streaming.worker import FeatureWorker as JaxWorker

    class J:
        pass
    j = J()
    j.jax, j.jnp, j.core, j.run_stream = jax, jnp, jcore, jax_run_stream
    j.Ckpt, j.repart, j.KV, j.Worker = JaxCkpt, jax_repart, JaxKV, JaxWorker
    j.key = jax.random.PRNGKey(SEED)
    return j


def _jax_local(jx, keys, qs, ts, *, batch, rounds, budget=0.0005):
    cfg = jx.core.EngineConfig(**CFG, budget=budget, exact_rounds=rounds)
    st, info = jx.run_stream(cfg, jx.core.init_state(E, 2), keys, qs, ts,
                             batch=batch, mode="exact", rng=jx.key)
    return [np.asarray(x) for x in st], info


@pytest.fixture(scope="module")
def data(tmp_path_factory, jx):
    """The streams, the measured ``exact_rounds``, the directories and a
    JAX-written checkpoint of the local JAX state in the 4-shard layout."""
    root = tmp_path_factory.mktemp("sharded")
    uni, skew = _uniform(), _extreme_skew()
    worker = _zipf(1200, E, 1.0, seed=2)
    zipf = _zipf(800, 96, 1.2, seed=1, gap=15.0)
    exact = [("block", uni, 32,
              _rounds(uni[0], n=N_RANKS, batch_per_shard=32,
                      local_batch=64)),
             ("virtual", skew, 16,
              _rounds(skew[0], n=N_RANKS, batch_per_shard=16,
                      layout="virtual", local_batch=16))]
    w_rounds = max(_rounds(worker[0], n=N_RANKS, batch_per_shard=32,
                           layout=lay, local_batch=128)
                   for lay in ("block", "virtual"))
    z_rounds = _rounds(zipf[0], n=N_RANKS, batch_per_shard=32,
                       layout="virtual", n_keys=96)
    rng = np.random.default_rng(0)
    w = 1.0 / np.arange(1, 129)
    padding = rng.permutation(128)[rng.choice(128, 1500, p=w / w.sum())]
    # two shards (the nested meshes): the rounds of a 2-shard block
    nested = [(lay, stream, B, _rounds(stream[0], n=2, batch_per_shard=B,
                                       layout=lay, local_batch=B))
              for lay, stream, B, _ in exact]
    d = dict(exact=exact, nested=nested, steps=tuple(x[:512] for x in uni),
             worker=worker,
             padding=padding,
             w_rounds=w_rounds, zipf=zipf, zipf_keys=96, z_rounds=z_rounds,
             dir=str(root), ckpt=str(root / "ckpt4"),
             jax_ckpt=str(root / "jax_ckpt4"))
    # the local JAX state of stream (a), in the 4-shard flat layout
    _, (keys, qs, ts), _, rounds = exact[0]
    js, _ = _jax_local(jx, keys, qs, ts, batch=64, rounds=rounds)
    perm = _perm("block", keys, N_RANKS)
    sharded = [np.empty_like(x) for x in js]
    for a, b in zip(sharded, js):
        a[perm] = b
    jx.Ckpt(d["jax_ckpt"], async_io=False).save(
        7, jx.core.ProfileState(*map(jx.jnp.asarray, sharded)))
    return d


@pytest.fixture(scope="module")
def suite(data):
    """One 4-rank spawn a part; each rank's results of both, merged."""
    ranks = [{} for _ in range(N_RANKS)]
    for part in ("engine", "storage"):
        got = run_ranks(_suite, N_RANKS, data, part, device="cpu",
                        timeout_s=TIMEOUT_S)
        assert [r["shard"] for r in got] == list(range(N_RANKS))
        for r, g in zip(ranks, got):
            r["jax_loaded"] = r.get("jax_loaded", False) or g["jax_loaded"]
            r.update({k: v for k, v in g.items() if k != "jax_loaded"})
    return ranks


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), what


def _state_equal(full, perm, want, what, exact=True):
    for f, a, b in zip(FIELDS, full, want):
        if exact:
            _bitwise(a[perm], b, f"{what}: {f}")
        else:
            np.testing.assert_allclose(a[perm], b, rtol=1e-6, atol=0,
                                       err_msg=f"{what}: {f}")


# --------------------------------------------------------------- tests
def test_ranks_import_no_jax(suite):
    assert not any(r["jax_loaded"] for r in suite)


@pytest.mark.parametrize("layout", ["block", "virtual"])
def test_sharded_run_stream_matches_local_stream(suite, data, jx, layout):
    """Exact ``run_stream`` on 4 ranks (the virtual layout under extreme
    skew) against JAX ``core.stream.run_stream``: z, p, writes and the
    permuted state bitwise, on every rank; the block layout's per-block
    write counts (``collect_info=False``) sum to the same."""
    i = ["block", "virtual"].index(layout)
    _, (keys, qs, ts), B, rounds = data["exact"][i]
    js, ji = _jax_local(jx, keys, qs, ts, batch=B, rounds=rounds)
    for r in suite:
        got = r["exact"][layout]
        _bitwise(got["z"], ji.z, "z")
        _bitwise(got["p"], ji.p, "p")
        _bitwise(got["lam_hat"], ji.lam_hat, "lam_hat")
        assert int(got["writes"]) == int(ji.writes)
        if layout == "block":
            assert int(got["writes_blocks"].sum()) == int(ji.writes)
            _bitwise(got["writes_blocks"],
                     suite[0]["exact"][layout]["writes_blocks"],
                     "writes per block")
    assert 0 < int(ji.writes) < len(keys)
    full = _full([r["exact"][layout] for r in suite])
    _state_equal(full, _perm(layout, keys, N_RANKS), js, layout)


def test_two_dim_data_axes_flatten_row_major(suite, data):
    """Data axes over a 2 x 2 mesh: the shard index is the row-major
    flattening (here the rank), and the run equals the 1-D mesh's."""
    assert [r["two_dim"]["shard"] for r in suite] == list(range(N_RANKS))
    for r in suite:
        _bitwise(r["two_dim"]["z"], r["exact"]["block"]["z"], "z")
        for a, b, f in zip(r["two_dim"]["state"],
                           r["exact"]["block"]["state"], FIELDS):
            _bitwise(a, b, f)


def test_nested_data_axes_groups_are_kept_and_checked(suite):
    """``shard_of_mesh`` over nested data axes makes the coset groups once
    a mesh (a second call returns the same group), and refuses a mesh
    whose coset ranks do not rise in shard order (a process group ranks
    its members by global rank, so shard and group rank would part)."""
    for r in suite:
        assert all(r["nested"][name, "cached"] for name in NESTED)
        assert "must rise in shard order" in r["nested"]["flipped"]


@pytest.mark.parametrize("shape", list(NESTED))
@pytest.mark.parametrize("layout", ["block", "virtual"])
def test_nested_data_axes_match_local_stream(suite, data, jx, shape,
                                             layout):
    """Data axes ("pod", "data") inside a 3-dim ("pod", "data", "model")
    mesh of (2, 1, 2) and (1, 2, 2) on 4 ranks: 2 shards, the shard the
    row-major index over the data axes, each "model" row a group of its
    own; exact ``run_stream`` on every rank against the JAX
    single-device engine, bitwise in z, p, lam_hat, writes and the state
    (each row's two shards concatenated, after the layout's
    permutation)."""
    i = ["block", "virtual"].index(layout)
    _, (keys, qs, ts), B, rounds = data["nested"][i]
    js, ji = _jax_local(jx, keys, qs, ts, batch=B, rounds=rounds)
    dims = NESTED[shape]
    runs = [r["nested"][shape, layout] for r in suite]
    for rank, got in enumerate(runs):
        pod, dat, _ = np.unravel_index(rank, dims)
        assert got["n"] == 2 and got["shard"] == pod * dims[1] + dat
        _bitwise(got["z"], ji.z, "z")
        _bitwise(got["p"], ji.p, "p")
        _bitwise(got["lam_hat"], ji.lam_hat, "lam_hat")
        assert int(got["writes"]) == int(ji.writes)
    perm = _perm(layout, keys, 2)
    for model in range(dims[2]):
        row = sorted((r for k, r in enumerate(runs)
                      if np.unravel_index(k, dims)[2] == model),
                     key=lambda r: r["shard"])
        _state_equal(_full(row), perm, js, f"{shape} {layout}")


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_sharded_step_per_micro_batch(suite, jx, mode):
    """``partition_events`` + ``make_step`` per routed micro-batch against
    the op-by-op JAX step with global keys from the same state, and
    against the port's one-card step fed the same blocks."""
    kw = dict(CFG, budget=0.0005, exact_rounds=16)
    jstep = jx.core.make_step(jx.core.EngineConfig(**kw), mode)
    tstep = make_step(EngineConfig(**kw), mode)
    perm = _perm("block", None, N_RANKS)
    writes = 0
    for i in range(len(suite[0]["steps"][mode]["steps"])):
        st = [r["steps"][mode]["steps"][i] for r in suite]
        cat = lambda f: np.concatenate([s[f] for s in st])
        gkey = np.concatenate([s["key"].astype(np.int64) * N_RANKS + r
                               for r, s in enumerate(st)])
        v = cat("valid")
        before = [x[perm] for x in _full(st, "before")]
        after = _full([r["steps"][mode]["steps"][i + 1] for r in suite],
                      "before") \
            if i + 1 < len(suite[0]["steps"][mode]["steps"]) \
            else _full([r["steps"][mode] for r in suite])
        js, ji = jstep(jx.core.ProfileState(*map(jx.jnp.asarray, before)),
                       jx.core.Event(key=jx.jnp.asarray(gkey.astype(
                           np.int32)), q=jx.jnp.asarray(cat("q")),
                           t=jx.jnp.asarray(cat("t")),
                           valid=jx.jnp.asarray(v)), jx.key)
        _bitwise(cat("z"), ji.z, "z")
        _bitwise(cat("p")[v], np.asarray(ji.p)[v], "p")
        np.testing.assert_allclose(cat("features")[v],
                                   np.asarray(ji.features)[v], rtol=1e-6,
                                   atol=1e-6)
        assert all(int(s["writes"]) == int(ji.writes) for s in st)
        _state_equal(after, perm, [np.asarray(x) for x in js],
                     f"{mode} step {i}", exact=mode == "exact")
        # the port's one-card step on the same global blocks: bitwise
        ts_, ti = tstep(state_from_numpy(*before, device="cpu"),
                        Event(key=torch.from_numpy(gkey),
                              q=torch.from_numpy(cat("q")),
                              t=torch.from_numpy(cat("t")),
                              valid=torch.from_numpy(v)), ROOT)
        for f in ("z", "p", "lam_hat", "features"):
            _bitwise(cat(f)[v], getattr(ti, f).numpy()[v], f)
        _state_equal(after, perm, [x.numpy() for x in ts_],
                     f"{mode} step {i} vs one card")
        writes += int(ji.writes)
    assert writes > 0


@pytest.mark.parametrize("layout", ["block", "virtual"])
def test_mesh_sink_byte_parity_and_hydrate(suite, data, jx, layout):
    """Durable write-behind on 4 ranks: every rank writes only its own
    partition, the ranks' bytes together equal the JAX per-event worker's
    store, and ``hydrate_state`` / ``hydrate_from_dir`` rebuild each
    rank's rows exactly."""
    keys, qs, ts = data["worker"]
    cfg = jx.core.EngineConfig(**CFG, budget=0.002,
                               exact_rounds=data["w_rounds"])
    store = jx.KV(seed=0)
    wkr = jx.Worker(cfg, store, rng=jx.key)
    for k, q, t in zip(keys.tolist(), qs.tolist(), ts.tolist()):
        wkr.process(k, q, t)
    merged = {}
    shard_of = _shard_of_key(layout, keys, N_RANKS)
    for r, rank in enumerate(suite):
        got = rank["sink"][layout]
        assert got["part"] == f"part-{r:04d}"
        assert all(shard_of[k] == r for k in got["bytes"])
        assert got["refused"]
        merged.update(got["bytes"])
        for f in ("last_t", "v_f", "agg"):
            i = FIELDS.index(f)
            _bitwise(got["hydrated"][i], got["state"][i], f)
            _bitwise(got["from_dir"][i], got["state"][i], f)
    assert set(merged) == set(store.data) and len(merged) > 0
    assert all(merged[k] == store.data[k] for k in merged)


def test_materialize_and_cold_match_jax(suite, data, jx):
    """``materialize`` on 4 ranks (computed on owners, placed) equals the
    one-card port engine on the same rows bitwise and JAX ``materialize``
    within rtol 1e-6 (std through its square, relative to the second
    moment); ``materialize_cold`` equals it bitwise."""
    keys, qs, ts = data["worker"]
    t_s = float(ts[-1]) + 1.0
    js, _ = _jax_local(jx, keys, qs, ts, batch=128,
                       rounds=data["w_rounds"], budget=0.002)
    want = np.asarray(jx.core.materialize_features(
        jx.core.ProfileState(*map(jx.jnp.asarray, js)),
        jx.jnp.arange(E), jx.jnp.float32(t_s), CFG["taus"]))
    for layout in ("block", "virtual"):
        full = _full([r["sink"][layout] for r in suite])
        perm = _perm(layout, keys, N_RANKS)
        one = materialize_features(
            state_from_numpy(*(x[perm] for x in full), device="cpu"),
            torch.arange(E), torch.tensor(t_s), CFG["taus"]).numpy()
        for r in suite:
            got = r["sink"][layout]
            _bitwise(got["warm"], one, f"{layout} materialize")
            _bitwise(got["cold"], got["warm"], f"{layout} cold")
        # count, sum, mean within rtol 1e-6; std = sqrt(m2 - mean^2)
        # cancels, so it is held through its square against m2
        T = len(CFG["taus"])
        np.testing.assert_allclose(one[:, :3 * T], want[:, :3 * T],
                                   rtol=1e-6, atol=0)
        mean, std = want[:, 2 * T:3 * T], want[:, 3 * T:]
        assert np.all(np.abs(one[:, 3 * T:] ** 2 - std ** 2)
                      <= 1e-6 * (mean ** 2 + std ** 2))


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_mesh_residency_and_depth2_parity(suite, mode):
    """8 slots a rank against the dense sharded run (virtual layout, a
    sink): serial and ``pipeline_depth=2`` give the same decisions,
    features and store bytes, with evictions and rehydrations."""
    evictions = rehydrations = 0
    for r in suite:
        runs = r["residency"][mode]
        for name in ("serial", "depth2"):
            for f in ("z", "p", "features"):
                _bitwise(runs[name][f], runs["dense"][f], f"{name} {f}")
            assert runs[name]["writes"] == runs["dense"]["writes"]
            assert runs[name]["bytes"] == runs["dense"]["bytes"]
        stats = runs["serial"]["stats"]
        evictions += stats["evictions"]
        # every miss past a key's first touch is a rehydration
        rehydrations += stats["misses"] - runs["serial"]["touched"]
    assert evictions > 0 and rehydrations > 0


def test_elastic_reshard_after_checkpoint(suite, data, jx, tmp_path):
    """Save on 4 ranks; the JAX ``CheckpointManager`` restores the port's
    checkpoint and the port's ranks restore the JAX one; restore onto 2
    ranks and onto one card through ``repartition_profile_state``, each
    equal to JAX's repartition, bitwise."""
    full4 = _full([r["ckpt"] for r in suite])
    for r in suite:
        for a, b, c, f in zip(r["ckpt"]["back"], r["ckpt"]["state"],
                              r["ckpt"]["jax_back"], FIELDS):
            _bitwise(a, b, f"restore {f}")
            _bitwise(c, b, f"JAX-written restore {f}")
    jstate = jx.Ckpt(data["ckpt"], async_io=False).restore(
        jx.core.init_state(E, 2))
    for a, b, f in zip(jstate, full4, FIELDS):
        _bitwise(np.asarray(a), b, f"JAX restore of the port's {f}")
    two = run_ranks(_restore_on, 2, data, device="cpu", timeout_s=TIMEOUT_S)
    want2 = jx.repart(jstate, old_shards=4, new_shards=2, num_keys=E)
    for f, a, b in zip(FIELDS, _full([{"state": s} for s in two]), want2):
        _bitwise(a, np.asarray(b), f"4 -> 2 {f}")
    one = repartition_profile_state(
        CheckpointManager(data["ckpt"], async_io=False).restore(
            init_state(E, 2, device="cpu")),
        old_shards=4, new_shards=1, num_keys=E, device="cpu")
    want1 = jx.repart(jstate, old_shards=4, new_shards=1, num_keys=E)
    for f, a, b in zip(FIELDS, one, want1):
        _bitwise(a.numpy(), np.asarray(b), f"4 -> 1 {f}")


def test_pipeline_build_mesh_scores(suite, data):
    """``ScoringPipeline.build(mesh=)``: features bitwise those of the
    single-shard pipeline, scores within rtol 1e-5; the restarts (from the
    sink, from the directory, ``run_restart_demo``) score bitwise like the
    live state; the frontend refuses a mesh."""
    keys, qs, ts = data["worker"]
    spec = ProfileSpec(**SPEC)
    pipe = pipeline.ScoringPipeline.build(spec, E, mode="exact",
                                          device="cpu",
                                          exact_rounds=data["w_rounds"])
    pipe.scorer = pipeline.init_scorer(torch.Generator().manual_seed(1),
                                       spec.feature_dim, device="cpu")
    _, info = pipe.process_stream(pipe.init(), keys, qs, ts, rng=ROOT,
                                  batch_per_shard=32 * N_RANKS)
    scores = pipeline.score(pipe.scorer, info.features).numpy()
    for r in suite:
        got = r["pipe"]
        _bitwise(got["z"], info.z.numpy(), "z")
        _bitwise(got["features"], info.features.numpy(), "features")
        np.testing.assert_allclose(got["scores"], scores, rtol=1e-5,
                                   atol=1e-6)
        _bitwise(got["from_sink"], got["live"], "restart_from")
        _bitwise(got["from_dir"], got["live"], "restart_from_dir")
        _bitwise(got["demo_rec"], got["demo_live"], "run_restart_demo")
        _bitwise(got["demo_live"], suite[0]["pipe"]["demo_live"], "ranks")
        assert not got["served"]


def test_virtual_layout_cuts_padding_under_mesh(suite, data):
    """``stream_layout_stats`` through the 4-rank engines: on a Zipf
    stream (128 keys, exponent 1) the virtual layout needs at most half
    the block layout's padded block slots, and both count every event."""
    keys = data["padding"]
    stats = suite[0]["layout_stats"]
    assert all(r["layout_stats"] == stats for r in suite)
    assert stats["block"]["events"] == stats["virtual"]["events"] \
        == len(keys)
    assert stats["virtual"]["padded_fraction"] * 2 \
        <= stats["block"]["padded_fraction"], stats


def _exact_only(mesh, d):
    return _exact_runs(mesh, d)


def test_sharded_run_stream_8_ranks(data, jx):
    """8 ranks (the JAX suite's 8 fake devices), both layouts, exact
    mode: bitwise to JAX ``core.stream.run_stream``."""
    d = dict(exact=[
        (lay, stream, B, _rounds(stream[0], n=8, batch_per_shard=B,
                                 layout=lay, local_batch=B))
        for lay, stream, B, _ in data["exact"]])
    ranks = run_ranks(_exact_only, 8, d, device="cpu", timeout_s=TIMEOUT_S)
    for lay, (keys, qs, ts), B, rounds in d["exact"]:
        js, ji = _jax_local(jx, keys, qs, ts, batch=B, rounds=rounds)
        for r in ranks:
            _bitwise(r[lay]["z"], ji.z, "z")
            _bitwise(r[lay]["p"], ji.p, "p")
            assert int(r[lay]["writes"]) == int(ji.writes)
        _state_equal(_full([r[lay] for r in ranks]), _perm(lay, keys, 8),
                     js, f"8 ranks {lay}")


# ------------------------------------------------- failure and storage
def _fail_or_hang(mesh, how, _payload):
    import torch.distributed as dist
    rank = mesh.get_local_rank("data")
    if how == "raises" and rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    if how == "exits" and rank == 1:
        os._exit(3)             # no report, no traceback: an exit code
    if how != "hangs":
        dist.barrier()          # never completes: rank 1 is gone
    time.sleep(3600)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("how", ["raises", "exits", "hangs"])
def test_failing_rank_fails_the_run_and_leaves_no_process(how):
    """A rank raises or exits (its peers wait in a collective), or every
    rank hangs: ``run_ranks`` raises within its timeout and kills every
    rank.  The job carries 8 MB, more than a pipe holds."""
    import multiprocessing
    timeout = 10.0 if how == "hangs" else 30.0
    t0 = time.perf_counter()
    with pytest.raises(RankFailed) as err:
        run_ranks(_fail_or_hang, 3, how, bytes(8 << 20), device="cpu",
                  timeout_s=timeout)
    assert time.perf_counter() - t0 < timeout + 10.0
    want = {"raises": "rank 1 fails on purpose", "exits": "exit code 3",
            "hangs": "still running"}[how]
    assert want in str(err.value)
    assert len(err.value.pids) == 3
    assert not any(_alive(p) for p in err.value.pids)
    assert not multiprocessing.active_children()


def _open_partition(mesh, store_dir):
    try:
        DurableStore(store_dir).close()
    except PartitionLockedError as e:
        return str(e)
    return None


def test_two_processes_never_open_one_partition(tmp_path):
    """A partition directory held by one process cannot be opened by
    another (two writers on one WAL would corrupt it); once closed, it
    can.  A rank's sink owns its partition only and refuses other rows."""
    d = str(tmp_path / "part-0000")
    held = DurableStore(d)
    try:
        (err,) = run_ranks(_open_partition, 1, d, device="cpu",
                           timeout_s=TIMEOUT_S)
        assert err is not None and "another process" in err
    finally:
        held.close()
    assert run_ranks(_open_partition, 1, d, device="cpu",
                     timeout_s=TIMEOUT_S) == [None]
    sink = WriteBehindSink(EngineConfig(**CFG, budget=0.002),
                           n_partitions=4, owned=(2,), backend="durable",
                           store_dir=str(tmp_path / "sink"), device="cpu")
    assert sorted(os.listdir(tmp_path / "sink")) == ["part-0002"]
    assert sink.partitions == (2,)
    rows = (np.zeros((4, 2), np.float32), np.zeros((2, 2, 3), np.float32))
    sink.submit(np.array([2, 6]), np.ones(2, bool), np.ones(2, bool), rows)
    sink.flush()
    assert set(sink.stores[0].data) == {2, 6}
    with pytest.raises(ValueError, match="owns only"):
        sink.submit_read(np.array([1]))
    sink.submit(np.array([2, 3]), np.ones(2, bool), np.ones(2, bool), rows)
    with pytest.raises(RuntimeError, match="write-behind flush failed"):
        sink.flush()
    assert set(sink.stores[0].data) == {2, 6}
    sink.close()
