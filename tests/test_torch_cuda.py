"""repro_torch on a CUDA device: the hand-written kernel and the engine.

These tests need a GPU (a CUDA kernel has no CPU mode) and skip without
one; they import no JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel is held bitwise to its plain PyTorch version on the CPU, which
``test_torch_kernels.py`` (rows in) and ``test_torch_keyed.py`` (keys in)
hold bitwise to the JAX reference; the engine on the card is held bitwise
to the engine on the CPU in exact mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (EngineConfig, ProfileState,  # noqa: E402
                              init_state, prng_key,
                              run_stream)
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.kernels import thinning_rmw as trmw          # noqa: E402

POLICIES = ["pp", "pp_vr", "full", "fixed", "unfiltered"]


def trmw_inputs(rng, B, T):
    """``tests/test_kernels.py::_trmw_inputs`` as float32 numpy arrays
    (same draws, same order): fresh and warm rows for both columns."""
    f32 = lambda x: np.asarray(x, np.float32)
    taus = f32(np.geomspace(60, 86400, T))
    fresh = rng.random(B) < 0.3
    last_t = f32(np.where(fresh, -1e38, rng.uniform(0, 1e4, B)))
    v_f = f32(np.where(fresh, 0, rng.uniform(0, 50, B)))
    agg = f32(rng.uniform(0, 10, (B, 3 * T))) * (~fresh[:, None])
    q = f32(rng.lognormal(3, 1, B))
    t = f32(rng.uniform(1e4, 2e4, B))
    u = f32(rng.random(B))
    valid = f32(rng.random(B) < 0.9)
    fresh_full = fresh & (rng.random(B) < 0.5)
    last_t_full = f32(np.where(fresh_full, -1e38, rng.uniform(0, 1.2e4, B)))
    v_full = f32(np.where(fresh_full, 0, rng.uniform(0, 80, B)))
    return taus, last_t, v_f, agg, q, t, u, valid, v_full, last_t_full


def keyed_inputs(rng, N, L, T, *, distinct=False, big_ent=False):
    """State tables and events for the keyed pass, as numpy arrays.

    The table has never-persisted rows (``-inf``) and NaN times in both
    columns; keys repeat and include N - 1.  ``distinct``: the valid
    events' keys are distinct (the write-back contract), invalid events
    carry key 0, and one valid event has key 0 too.  ``big_ent``: a
    counter-RNG entity other than the key, at or above 2^31.
    """
    f32 = lambda x: np.asarray(x, np.float32)
    taus = f32(np.geomspace(60, 86400, T))
    fresh = rng.random(N) < 0.3
    nan = rng.random(N) < 0.05
    last_t = f32(np.where(fresh, -np.inf, rng.uniform(0, 1e4, N)))
    last_t[nan & ~fresh] = np.nan
    v_f = f32(np.where(fresh, 0, rng.uniform(0, 50, N)))
    agg = f32(rng.uniform(0, 10, (N, T, 3))) * (~fresh[:, None, None])
    fresh_full = fresh & (rng.random(N) < 0.5)
    last_t_full = f32(np.where(fresh_full, -np.inf,
                               rng.uniform(0, 1.2e4, N)))
    last_t_full[rng.random(N) < 0.05] = np.nan
    v_full = f32(np.where(fresh_full, 0, rng.uniform(0, 80, N)))
    valid = rng.random(L) < 0.85
    if distinct:
        key = rng.choice(np.arange(1, N - 1), L, replace=False)
        key[~valid] = 0
        valid[L // 2] = True
        key[L // 2] = 0
    else:
        key = rng.integers(0, N, L)
        key[1::7] = key[0]
    valid[-1] = True
    key[-1] = N - 1
    ent = rng.integers(2 ** 31, 2 ** 32, L) if big_ent else key
    q = f32(rng.lognormal(3, 1, L))
    t = f32(rng.uniform(1e4, 2e4, L))
    return ((taus, last_t, v_f, agg, v_full, last_t_full),
            (key.astype(np.int64), ent.astype(np.int64), q, t, valid))


def keyed_lanes(rng, L):
    """A chunk's lane index: every event once, in shuffled order, with
    empty slots (L) among them."""
    lanes = np.concatenate([rng.permutation(L), np.full(L // 8, L)])
    return rng.permutation(lanes).astype(np.int64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _bitwise(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bool:
        return a.shape == b.shape and torch.equal(a, b)
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1, 6), (16, 3), (100, 6), (250, 3),
                                 (512, 2), (4096, 6)])
@pytest.mark.parametrize("policy", POLICIES)
def test_kernel_bitwise_vs_plain_cpu(cuda_device, B, T, policy):
    args = trmw_inputs(np.random.default_rng([B, T, len(policy)]), B, T)
    kw = dict(h=3600.0, budget=0.001, alpha=1.5, policy=policy,
              fixed_rate=0.3, mu_tau_index=min(2, T - 1))
    want = ops.thinning_rmw(*(torch.tensor(a) for a in args), **kw)
    launches = trmw.launches
    got = ops.thinning_rmw(*(torch.tensor(a, device=cuda_device)
                             for a in args), **kw)
    torch.cuda.synchronize()
    assert trmw.launches == launches + 1
    for g, w in zip(got, want):
        assert g.device == cuda_device and _bitwise(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_engine_on_card_matches_cpu(cuda_device, mode):
    """Exact mode: decisions and state bitwise between the card and the
    CPU.  Fast mode: the first block's decisions bitwise (same start
    state); after it the fold's exp and sums round differently on the two
    devices and the difference carries, so p and the state agree to 1e-5;
    two card runs are identical."""
    rng = np.random.default_rng(0)
    n_keys, n, batch = 64, 2000, 256
    w = 1.0 / np.arange(1, n_keys + 1) ** 1.1
    keys = rng.choice(n_keys, n, p=w / w.sum()).astype(np.int32)
    ts = np.cumsum(rng.exponential(20.0, n)).astype(np.float32)
    qs = rng.lognormal(3.0, 1.0, n).astype(np.float32)
    rounds = max(int(np.bincount(keys[i:i + batch]).max())
                 for i in range(0, n, batch))
    cfg = EngineConfig(taus=(60.0, 3600.0, 86400.0), h=600.0,
                       budget=0.002, alpha=1.0, policy="pp_vr",
                       exact_rounds=rounds)
    run = lambda dev: run_stream(cfg, init_state(n_keys, 3, device=dev),
                                 keys, qs, ts, batch=batch, mode=mode,
                                 rng=prng_key(7))
    launches = trmw.keyed_launches
    (gs, gi), (gs2, _), (cs, ci) = (run(cuda_device), run(cuda_device),
                                    run("cpu"))
    n_blocks = -(-n // batch)
    # one keyed launch per fast block, per exact chunk (1 + rounds a block)
    per_block = 1 if mode == "fast" else 1 + rounds
    assert trmw.keyed_launches - launches == 2 * n_blocks * per_block
    agree = n if mode == "exact" else batch
    for name in ("z", "p", "lam_hat"):
        assert _bitwise(getattr(gi, name)[:agree],
                        getattr(ci, name)[:agree]), name
    np.testing.assert_allclose(gi.p.cpu().numpy(), ci.p.numpy(), rtol=1e-5)
    assert float((gi.z.cpu() == ci.z).float().mean()) >= 0.999
    for a, a2, b, name in zip(gs, gs2, cs, gs._fields):
        assert _bitwise(a, a2), name
        if mode == "exact":
            assert _bitwise(a, b), name
        else:
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-5, atol=0, err_msg=name)


def _keyed_case(device, T, policy, write_back, big_ent, seed):
    """The keyed pass on ``device`` over one generated case; returns the
    outputs and the state afterwards, on the CPU."""
    rng = np.random.default_rng(seed)
    (taus, *table), (key, ent, q, t, valid) = keyed_inputs(
        rng, 5000, 700, T, distinct=write_back, big_ent=big_ent)
    lanes = keyed_lanes(rng, 700)
    dev = lambda x: torch.tensor(x, device=device)
    state = ProfileState(*(dev(x) for x in table))
    kw = dict(h=3600.0, budget=0.001, alpha=1.5, policy=policy,
              fixed_rate=0.3, mu_tau_index=min(2, T - 1))
    out = None
    if write_back:
        out = (torch.zeros(700, dtype=torch.bool, device=device),
               torch.full((700,), -1.0, device=device),
               torch.full((700, 4 * T), -1.0, device=device),
               torch.full((700,), -1.0, device=device))
    got = ops.thinning_rmw_keyed(
        dev(taus), state, dev(key), dev(q), dev(t), dev(valid), (7, 42),
        dev(ent), write_back=write_back, out=out,
        lanes=dev(lanes) if write_back else None, **kw)
    return [x.cpu() for x in got], [x.cpu() for x in state]


@pytest.mark.cuda
@pytest.mark.parametrize("write_back", [False, True])
@pytest.mark.parametrize("T", [2, 3, 6, 17])
@pytest.mark.parametrize("policy", POLICIES)
def test_keyed_kernel_bitwise_vs_plain_cpu(cuda_device, write_back, T,
                                           policy):
    """Both modes, all 9 outputs' worth (decisions and, with write-back,
    the state in place), bitwise; T = 17 takes the taus past the lanes'
    registers.  The write-back chunk has empty slots, invalid events on key
    0 and one valid event on key 0 (the padding lanes' key)."""
    seed = [T, POLICIES.index(policy), write_back]
    launches = trmw.keyed_launches
    got, got_state = _keyed_case(cuda_device, T, policy, write_back,
                                 T % 2 == 0, seed)
    torch.cuda.synchronize()
    assert trmw.keyed_launches == launches + 1
    want, want_state = _keyed_case("cpu", T, policy, write_back, T % 2 == 0,
                                   seed)
    for g, w in zip(got + got_state, want + want_state):
        assert _bitwise(g, w)


@pytest.mark.cuda
def test_keyed_kernel_refuses_bad_inputs(cuda_device):
    state = init_state(16, 2, device=cuda_device)
    taus = torch.tensor([60.0, 3600.0], device=cuda_device)
    key = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    f = torch.zeros(4, device=cuda_device)
    valid = torch.ones(4, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="key"):
        trmw.thinning_rmw_keyed_cuda(taus, state, key, f, f, valid, (0, 0),
                                     h=600.0, budget=0.01)


def _zipf_stream(n, n_keys, seed=0):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_keys + 1) ** 1.1
    keys = rng.choice(n_keys, n, p=w / w.sum()).astype(np.int32)
    ts = np.cumsum(rng.exponential(5.0, n)).astype(np.float32)
    qs = rng.lognormal(3.0, 1.0, n).astype(np.float32)
    return keys, qs, ts


def _stored(sink):
    sink.flush()
    merged = {}
    for s in sink.stores:
        merged.update(s.data)
    sink.close()
    return merged


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_resident_and_pipelined_on_card_bitwise(cuda_device, mode):
    """On the card, where the pipelined plane's copies really are
    asynchronous: resident (serial) == dense, and resident at depth 2 ==
    resident serial — decisions, features and stored bytes bitwise, with
    evictions, rehydrations, the L2 tier and split groups in the run."""
    from repro_torch.streaming.persistence import WriteBehindSink
    from repro_torch.streaming.residency import ResidencyMap

    n_keys, batch, group = 512, 256, 2
    keys, qs, ts = _zipf_stream(12_000, n_keys)
    rounds = max(int(np.bincount(keys[i:i + batch]).max())
                 for i in range(0, len(keys), batch))
    cfg = EngineConfig(taus=(60.0, 3600.0, 86400.0), h=600.0,
                       budget=0.002, alpha=1.0, policy="pp_vr",
                       exact_rounds=rounds)

    def run(slots=None, depth=1):
        sink = WriteBehindSink(cfg, n_partitions=3, l2=64,
                               device=cuda_device)
        rmap = ResidencyMap(n_keys, slots) if slots else None
        _, info = run_stream(cfg, init_state(slots or n_keys, 3,
                                             device=cuda_device),
                             keys, qs, ts, batch=batch, mode=mode,
                             rng=prng_key(7), sink=sink, sink_group=group,
                             residency=rmap, pipeline_depth=depth)
        return info, _stored(sink), rmap

    dense, dense_bytes, _ = run()
    serial, serial_bytes, rmap = run(slots=160)
    piped, piped_bytes, rmap2 = run(slots=160, depth=2)
    assert rmap.stats.evictions > 0 and rmap.stats.misses > 160
    assert rmap.stats.splits > 0
    assert rmap.stats.snapshot() == rmap2.stats.snapshot()
    for name in ("z", "p", "lam_hat", "features"):
        assert _bitwise(getattr(dense, name), getattr(serial, name)), name
        assert _bitwise(getattr(serial, name), getattr(piped, name)), name
    assert dense_bytes == serial_bytes == piped_bytes and dense_bytes


@pytest.mark.cuda
def test_worker_on_card_matches_sink(cuda_device):
    """The per-event worker on the card (the rows entry at B = 1, the
    uniform drawn on the host) stores the exact sink's bytes; it launches
    the rows entry once an event and never runs the RNG on the card."""
    from repro_torch.kernels import threefry
    from repro_torch.streaming.kvstore import KVStore
    from repro_torch.streaming.persistence import WriteBehindSink
    from repro_torch.streaming.worker import FeatureWorker

    keys, qs, ts = _zipf_stream(600, 64, seed=1)
    cfg = EngineConfig(taus=(60.0, 3600.0), h=600.0, budget=0.002,
                       policy="pp", exact_rounds=64)
    sink = WriteBehindSink(cfg, n_partitions=1, device=cuda_device)
    run_stream(cfg, init_state(64, 2, device=cuda_device), keys, qs, ts,
               batch=128, mode="exact", rng=prng_key(3), sink=sink)
    worker = FeatureWorker(cfg, KVStore(), rng=prng_key(3),
                           device=cuda_device)
    launches, rng_calls = trmw.launches, threefry.cuda_calls
    for k, q, t in zip(keys.tolist(), qs.tolist(), ts.tolist()):
        worker.process(k, q, t)
    assert trmw.launches - launches == len(keys)
    assert threefry.cuda_calls == rng_calls
    assert worker.store.data == _stored(sink)


def _frontend_cfg(keys, batch, policy="pp_vr"):
    rounds = max(int(np.bincount(keys[i:i + batch]).max())
                 for i in range(0, len(keys), batch))
    return EngineConfig(taus=(60.0, 3600.0, 86400.0), h=600.0,
                        budget=0.002, alpha=1.0, policy=policy,
                        exact_rounds=rounds)


@pytest.mark.cuda
def test_frontend_capacity_on_card_equals_closed_loop(cuda_device):
    """``chip_smoke.py`` phase 8 (a) at a small size: a burst through the
    frontend on the card (fast mode, all batches full, memory sink) equals
    ``run_stream`` at the same batch on the card bit for bit — decisions,
    features, scores, stored bytes — with one keyed launch a dispatch and
    no plain step on a CUDA tensor."""
    from repro_torch.kernels import ref, threefry
    from repro_torch.serving import pipeline
    from repro_torch.serving.frontend import (RealClock, ServingFrontend,
                                              make_requests, score_at_width)
    from repro_torch.streaming.persistence import WriteBehindSink

    n_keys, batch = 512, 256
    keys, qs, ts = _zipf_stream(8 * batch, n_keys)
    cfg = _frontend_cfg(keys, batch)
    scorer = pipeline.init_scorer(torch.Generator().manual_seed(0), 12,
                                  device=cuda_device)
    sink = WriteBehindSink(cfg, n_partitions=2, device=cuda_device)
    fe = ServingFrontend(cfg, init_state(n_keys, 3, device=cuda_device),
                         batch=batch, max_wait_s=2e-3, mode="fast",
                         rng=prng_key(7), clock=RealClock(), sink=sink,
                         scorer=scorer)
    calls = threefry.cuda_calls + ref.gather_cuda_calls
    launches = trmw.keyed_launches
    res = fe.run(make_requests(keys, qs, ts, np.zeros(len(keys))))
    assert res.stats.dispatches == res.stats.full_batches == 8
    assert trmw.keyed_launches - launches == 8
    assert threefry.cuda_calls + ref.gather_cuda_calls == calls
    sink_c = WriteBehindSink(cfg, n_partitions=2, device=cuda_device)
    _, info = run_stream(cfg, init_state(n_keys, 3, device=cuda_device),
                         keys, qs, ts, batch=batch, mode="fast",
                         rng=prng_key(7), sink=sink_c)
    for name in ("z", "p", "lam_hat", "features"):
        assert _bitwise(torch.from_numpy(getattr(res, name)),
                        getattr(info, name)), name
    want = np.concatenate([score_at_width(scorer, info.features[i:i + batch],
                                          batch)
                           for i in range(0, len(keys), batch)])
    assert np.array_equal(res.scores.view(np.uint32), want.view(np.uint32))
    assert _stored(sink) == _stored(sink_c)
    assert np.all(res.latency_s > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("admission", ["serial", "threaded"])
def test_frontend_exact_on_card_under_partial_batches(cuda_device,
                                                     admission):
    """Phase 8 (c) at a small size: open-loop arrivals on the virtual
    clock force partial batches padded with key 0 beside real key-0
    events; exact mode on the card equals the exact ``run_stream`` on the
    card bit for bit, serial or threaded admission (the threaded plane's
    staging copies run on their own stream)."""
    from repro_torch.serving.frontend import (ServingFrontend,
                                              VirtualClock, make_requests)

    n_keys, batch = 64, 64
    keys, qs, ts = _zipf_stream(1500, n_keys, seed=2)
    cfg = _frontend_cfg(keys, batch)
    fe = ServingFrontend(cfg, init_state(n_keys, 3, device=cuda_device),
                         batch=batch, max_wait_s=2.5e-3, mode="exact",
                         rng=prng_key(7), clock=VirtualClock(),
                         admission=admission)
    res = fe.run(make_requests(keys, qs, ts, np.arange(1500) * 1e-4))
    assert res.stats.deadline_batches > 0 and res.stats.padded_lanes > 0
    _, info = run_stream(cfg, init_state(n_keys, 3, device=cuda_device),
                         keys, qs, ts, batch=batch, mode="exact",
                         rng=prng_key(7))
    for name in ("z", "p", "lam_hat", "features"):
        assert _bitwise(torch.from_numpy(getattr(res, name)),
                        getattr(info, name)), name


@pytest.mark.cuda
def test_frontend_resident_threaded_on_card(cuda_device):
    """Phase 8 (d) at a small size: a bounded resident set under threaded
    admission (threaded sink, ``overflow="block"``) equals the dense
    serial frontend on the card bit for bit, with prefetched
    rehydrations in the run."""
    from repro_torch.serving.frontend import (ServingFrontend,
                                              VirtualClock, make_requests)
    from repro_torch.streaming.persistence import WriteBehindSink
    from repro_torch.streaming.residency import ResidencyMap

    n_keys, batch = 512, 64
    keys, qs, ts = _zipf_stream(4000, n_keys, seed=4)
    cfg = _frontend_cfg(keys, batch)
    arrivals = np.arange(4000) * 2e-4

    def run(slots=None, admission="serial"):
        sink = WriteBehindSink(cfg, n_partitions=3, device=cuda_device)
        rmap = ResidencyMap(n_keys, slots) if slots else None
        fe = ServingFrontend(cfg, init_state(slots or n_keys, 3,
                                             device=cuda_device),
                             batch=batch, max_wait_s=2.5e-3, mode="fast",
                             rng=prng_key(7), clock=VirtualClock(),
                             sink=sink, residency=rmap, admission=admission)
        return fe.run(make_requests(keys, qs, ts, arrivals)), _stored(sink)

    dense, dense_bytes = run()
    res, res_bytes = run(slots=160, admission="threaded")
    assert res.stats.prefetch_rehydrations > 0
    for name in ("z", "p", "lam_hat", "features"):
        assert np.array_equal(getattr(dense, name), getattr(res, name)), name
    assert dense_bytes == res_bytes and dense_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_kill_mid_flush_on_card(cuda_device, mode, tmp_path):
    """Phase 8 (e): the SIGKILL victim runs on the card (it loads the
    built kernel); the recovered store equals the card reference over the
    acknowledged prefix byte for byte."""
    import signal

    from repro_torch.streaming import faults
    from repro_torch.streaming.durable import DurableStore

    d = str(tmp_path / "victim")
    rc, acked, err = faults.spawn_kill_mid_flush(
        d, policy="pp", mode=mode, kill_at_write=2, device="cuda")
    assert rc == -signal.SIGKILL, f"victim exited {rc}: {err[-2000:]}"
    assert acked > 0
    with DurableStore(d) as rec:
        ref = faults.run_reference("pp", mode, acked, device="cuda")
        assert rec.data == ref.data and rec.data


@pytest.mark.cuda
def test_index_less_cuda_device_resolves_to_the_card(cuda_device):
    """``device="cuda"`` and the state's own ``cuda:0`` name one device:
    a sink and a state built from either spelling work together."""
    from repro_torch.core.types import resolve_device
    from repro_torch.streaming.persistence import WriteBehindSink

    assert resolve_device("cuda") == cuda_device == resolve_device(None)
    cfg = EngineConfig(taus=(60.0,), h=600.0, budget=0.01)
    sink = WriteBehindSink(cfg, device="cuda")
    run_stream(cfg, init_state(8, 1, device=cuda_device),
               np.arange(8, dtype=np.int32), np.ones(8, np.float32),
               np.arange(8, dtype=np.float32), batch=8, sink=sink)
    assert sink.flush()["puts"] > 0
    sink.close()


def _sharded_ranks(mesh, keys, qs, ts, mode, rounds):
    """One rank of the sharded engine on the card: a run with a sink, the
    rank's keyed launches and its plain steps on the card."""
    from repro_torch.features.engine import ShardedFeatureEngine
    from repro_torch.kernels import ref, threefry

    cfg = EngineConfig(taus=(60.0, 3600.0), h=600.0, budget=0.002,
                       policy="pp", exact_rounds=rounds)
    eng = ShardedFeatureEngine(cfg, 64, mesh=mesh, mode=mode)
    trmw.keyed_launches = threefry.cuda_calls = ref.gather_cuda_calls = 0
    sink = eng.make_sink()
    st, info = eng.run_stream(eng.init_state(), keys, qs, ts,
                              batch_per_shard=32, rng=prng_key(3),
                              sink=sink)
    sink.flush()
    sink.close()
    return {"device": str(st.last_t.device), "launches": trmw.keyed_launches,
            "blocks": eng.stream_layout_stats(keys, 32)["n_blocks"],
            "plain": threefry.cuda_calls + ref.gather_cuda_calls,
            "state": [x.cpu().numpy() for x in st],
            "info": [getattr(info, f).cpu().numpy()
                     for f in ("z", "p", "lam_hat", "features")],
            "bytes": dict(sink.stores[0].data)}


@pytest.mark.cuda
@pytest.mark.parametrize("n,backend", [(4, "gloo"), (1, "nccl")])
def test_sharded_engine_ranks_on_the_card(cuda_device, n, backend):
    """Phase 9 (b)/(f) in small: ``n`` ranks on ``cuda:0`` (gloo collectives
    on host tensors; one NCCL rank on CUDA tensors), exact mode through
    the sink, bitwise equal to the one-card engine: decisions, the
    permuted state, store bytes.  Every rank launches the keyed kernel and
    runs no plain step on the card."""
    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.features.engine import ShardedFeatureEngine

    trmw.KERNEL.build()                 # once, before the ranks load it
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 64, 1200).astype(np.int32)
    qs = rng.lognormal(3, 1, 1200).astype(np.float32)
    ts = np.sort(rng.uniform(0, 2e5, 1200)).astype(np.float32)
    rounds = int(np.bincount(keys).max())
    ranks = run_ranks(_sharded_ranks, n, keys, qs, ts, "exact", rounds,
                      backend=backend, device="cuda:0", timeout_s=120.0)
    cfg = EngineConfig(taus=(60.0, 3600.0), h=600.0, budget=0.002,
                       policy="pp", exact_rounds=rounds)
    one = ShardedFeatureEngine(cfg, 64, mode="exact", device=cuda_device)
    sink = one.make_sink()
    st, info = one.run_stream(one.init_state(), keys, qs, ts,
                              batch_per_shard=128, rng=prng_key(3),
                              sink=sink)
    sink.flush()
    sink.close()
    merged = {}
    for r in ranks:
        assert r["device"] == "cuda:0" and r["plain"] == 0
        assert r["launches"] == r["blocks"] * (1 + rounds)
        merged.update(r["bytes"])
        for f, a in zip(("z", "p", "lam_hat", "features"), r["info"]):
            assert np.array_equal(a.view(np.uint8), getattr(info, f).cpu()
                                  .numpy().view(np.uint8)), f
    k = np.arange(64)
    e_local = -(-64 // n)
    perm = (k % n) * e_local + k // n
    for i, x in enumerate(st):
        full = np.concatenate([r["state"][i] for r in ranks])
        assert np.array_equal(full[perm].view(np.uint8),
                              x.cpu().numpy().view(np.uint8)), i
    assert merged == dict(sink.stores[0].data) and merged


def _bf16_ratio(got, want):
    """The largest |got - want| over the bf16 limit: two ulps of each value
    plus 2^-7 of its row's largest value (``chip_smoke.py`` phase 4)."""
    got, want = got.float().cpu(), want.float().cpu()
    limit = 2.0 ** -6 * want.abs() + \
        2.0 ** -7 * want.abs().amax(-1, keepdim=True)
    return float(((got - want).abs() / limit).max())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [80, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [4, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_dense_head_dims_vs_plain(cuda_device, D, causal, G,
                                                  dtype):
    """The head widths of the dense and audio families (Qwen3, Yi and
    Command-R: 128; HuBERT: 80, where the second 64-column TMA box is
    mostly past D) at a ragged length, global causal and non-causal, GQA
    groups of 4 and 12, against the plain version on the card."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, Kh, S = 2, 2, 300
    gen = torch.Generator(device=cuda_device).manual_seed(D * G + causal)
    q = torch.randn(B, Kh * G, S, D, generator=gen, device=cuda_device)
    k, v = (torch.randn(B, Kh, S, D, generator=gen, device=cuda_device)
            for _ in range(2))
    q, k, v = (x.to(getattr(torch, dtype)) for x in (q, k, v))
    launches = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == launches + 1
    assert bool(torch.isfinite(got).all())
    if dtype == "bfloat16":
        ratio = _bf16_ratio(got, want)
        assert ratio <= 1.0, f"error at {ratio} of the limit"
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [True, False])
def test_decay_scan_bitwise_at_the_mamba2_chunk_shape(cuda_device, with_h0):
    """Mamba-2's inter-chunk recurrence at batch 2 and S = 4096: 16 chunks
    over B*H*N*P = 1,310,720 channels, bitwise equal to the plain loop."""
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import ref

    T, C = 16, 1_310_720
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    a = torch.rand(T, C, generator=gen, device=cuda_device)
    u = torch.randn(T, C, generator=gen, device=cuda_device)
    h0 = torch.randn(C, generator=gen, device=cuda_device) if with_h0 \
        else None
    launches = ds.launches
    got = ops.decay_scan(a, u, h0)
    want = ref.decay_scan_ref(a, u, h0)
    torch.cuda.synchronize()
    assert ds.launches == launches + 1
    assert _bitwise(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "yi-9b", "smollm-360m",
                                  "command-r-plus-104b", "mamba2-2.7b",
                                  "hubert-xlarge"])
def test_family_serve_steps_on_card_match_cpu(cuda_device, arch):
    """The smoke config of each dense, SSM and audio arch in float32:
    prefill and four decode steps (the encoder: one encode) on the card,
    through the kernels, against the CPU with the plain versions, same
    weights; logits within rtol = atol = 5e-4 (float32 sums in another
    order, as the JAX parity tests allow), one kernel launch per layer."""
    from repro_torch.configs.base import load_smoke_config
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import backbone
    from repro_torch.serving.engine import make_serve_step

    run = load_smoke_config(arch)
    cfg = run.model
    params = backbone.init_params(cfg, torch.Generator().manual_seed(5),
                                  torch.float32, "cpu")
    card = backbone.init_params(cfg, torch.Generator().manual_seed(5),
                                torch.float32, "cpu").to(cuda_device)
    rng = np.random.default_rng(5)
    kw = dict(compute_dtype=torch.float32, max_len=36)
    if not cfg.causal:
        x = torch.tensor(rng.normal(size=(2, 32, cfg.frame_dim)),
                         dtype=torch.float32)
        runs = [(x, None)]
    else:
        x = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 32)))
        runs = [(x, torch.tensor(rng.integers(0, cfg.vocab_size, (2, 4))))]
    kinds = backbone.layer_plan(cfg).kinds
    want_launches = (kinds.count("ssd"), kinds.count("attn"))
    for prompt, steps in runs:
        outs = []
        for p, dev in ((params, "cpu"), (card, cuda_device)):
            prefill = make_serve_step(run, "prefill", **kw)
            before = (ds.launches, fa.launches)
            with torch.inference_mode():
                out = prefill(p, prompt.to(dev))
                got = [out if steps is None else out[0]]
                if steps is not None:
                    decode = make_serve_step(
                        run, "decode", compute_dtype=torch.float32)
                    state = out[1]
                    for t in range(steps.shape[1]):
                        logits, state = decode(p, state,
                                               steps[:, t:t + 1].to(dev))
                        got.append(logits)
            launched = (ds.launches - before[0], fa.launches - before[1])
            assert launched == ((0, 0) if dev == "cpu" else want_launches)
            outs.append([g.cpu() for g in got])
        for w, g in zip(*outs):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=5e-4,
                                       atol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 2, 333, 100, 128),
                                   (1, 64, 8, 1000, 1600, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cross_shapes_vs_plain(cuda_device, shape, dtype):
    """Non-causal cross-attention with Sq != Skv (the vision family's
    queries over its 1600 vision tokens, and a small ragged case with
    Sq > Skv) against the plain version on the card."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, H, Kh, Sq, Skv, D = shape
    gen = torch.Generator(device=cuda_device).manual_seed(Sq + Skv)
    q = torch.randn(B, H, Sq, D, generator=gen, device=cuda_device)
    k, v = (torch.randn(B, Kh, Skv, D, generator=gen, device=cuda_device)
            for _ in range(2))
    q, k, v = (x.to(getattr(torch, dtype)) for x in (q, k, v))
    launches = fa.launches
    got = ops.flash_attention(q, k, v, causal=False)
    want = ref.attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.launches == launches + 1
    assert bool(torch.isfinite(got).all())
    if dtype == "bfloat16":
        ratio = _bf16_ratio(got, want)
        assert ratio <= 1.0, f"error at {ratio} of the limit"
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                                  "llama-3.2-vision-90b"])
def test_moe_vision_serve_steps_on_card_match_cpu(cuda_device, arch):
    """The smoke config of each MoE and vision arch in float32, its zero
    gates drawn (so cross-attention and the shared-expert gate count):
    prefill and four decode steps on the card, through the kernel, against
    the CPU with the plain version, same weights; logits within rtol =
    atol = 5e-4 (float32 sums in another order), one attention launch per
    attn, moe and cross layer."""
    from repro_torch.configs.base import load_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import backbone
    from repro_torch.serving.engine import make_serve_step

    run = load_smoke_config(arch)
    cfg = run.model
    gen = torch.Generator().manual_seed(5)
    params = backbone.init_params(cfg, gen, torch.float32, "cpu")
    with torch.no_grad():
        for layer in params["layers"]:
            for name in ("gate_attn", "gate_mlp"):
                if name in layer:
                    layer[name].uniform_(0.5, 1.5, generator=gen)
            if "moe" in layer and "shared_gate" in layer["moe"]:
                layer["moe"]["shared_gate"].normal_(0.0, 0.2, generator=gen)
    card = backbone.init_params(cfg, torch.Generator().manual_seed(5),
                                torch.float32, "cpu")
    card.load_state_dict(params.state_dict())
    card = card.to(cuda_device)
    rng = np.random.default_rng(5)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 32)))
    steps = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 4)))
    image = torch.tensor(rng.normal(size=(2, cfg.num_vision_tokens,
                                          cfg.d_model)),
                         dtype=torch.float32) \
        if cfg.family == "vlm" else None
    kinds = backbone.layer_plan(cfg).kinds
    outs = []
    for p, dev in ((params, "cpu"), (card, cuda_device)):
        prefill = make_serve_step(run, "prefill", compute_dtype=torch.float32,
                                  max_len=36)
        decode = make_serve_step(run, "decode", compute_dtype=torch.float32)
        before = fa.launches
        with torch.inference_mode():
            logits, state = prefill(p, prompt.to(dev), None if image is None
                                    else image.to(dev))
            got = [logits]
            for t in range(steps.shape[1]):
                logits, state = decode(p, state, steps[:, t:t + 1].to(dev))
                got.append(logits)
        want_launches = 0 if dev == "cpu" else \
            sum(kinds.count(k) for k in ("attn", "moe", "cross"))
        assert fa.launches - before == want_launches
        outs.append([g.cpu() for g in got])
    for w, g in zip(*outs):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=5e-4,
                                   atol=5e-4)


# ---------------------------------------------------------------- backward
def _normwise(got, want):
    """max |got - want| over max |want|, in float32."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("T,C", [(1, 1), (37, 5), (129, 16), (300, 64),
                                 (256, 100), (4096, 2560), (16, 1_310_720),
                                 (100, 3000), (127, 37), (128, 36)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_decay_scan_bwd_bitwise_vs_plain(cuda_device, T, C, with_h0):
    """The reverse scan against its plain loop on the card, bitwise in da,
    du and dh0: ragged T and C (the copy path at C = 5, 37 and 100 not a
    multiple of 4), RecurrentGemma's [4096, 2560], and the short path
    below 128 steps (Mamba-2's [16, 1,310,720], T = 100 and 127) beside
    the ring at exactly one full stage."""
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import ref

    gen = torch.Generator(device=cuda_device).manual_seed(T * 7 + C)
    a = torch.rand(T, C, generator=gen, device=cuda_device)
    u = torch.randn(T, C, generator=gen, device=cuda_device)
    g = torch.randn(T, C, generator=gen, device=cuda_device)
    h0 = torch.randn(C, generator=gen, device=cuda_device) if with_h0 \
        else None
    h = ops.decay_scan(a, u, h0)
    launches = ds.bwd_launches
    got = ds.decay_scan_bwd_cuda(a, h, g, h0)
    want = ref.decay_scan_bwd_ref(a, h, g, h0)
    torch.cuda.synchronize()
    assert ds.bwd_launches == launches + 1
    for x, y in zip(got, want):
        assert (x is None) == (y is None)
        if x is not None:
            assert _bitwise(x, y)


BWD_CASES = [(2, 4, 4, 64, 64, 64, True, 0, 0.0),        # MHA
             (2, 8, 2, 100, 100, 64, True, 0, 0.0),      # GQA, ragged
             (1, 10, 1, 300, 300, 256, True, 128, 0.0),  # MQA, window
             (1, 4, 1, 150, 150, 128, True, 0, 30.0),    # softcap
             (2, 4, 2, 77, 130, 80, False, 0, 0.0),      # non-causal
             (1, 2, 1, 90, 50, 48, False, 0, 0.0),       # Sq > Skv
             (1, 6, 3, 200, 200, 40, True, 64, 20.0),    # all of them
             (1, 4, 2, 70, 90, 36, True, 0, 0.0),        # no TMA (D % 8)
             (1, 4, 1, 200, 200, 128, True, 70, 0.0)]    # window in a tile
# shapes where the bfloat16 dK/dV kernel splits the query-head group over
# blocks (at 132 SMs: 9 splits of 12 heads, 7 of 10, 6 of 6), with windows
# that end inside a key tile and Skv not a multiple of 64
SPLIT_CASES = [(1, 12, 1, 2000, 2000, 64, True, 100, 0.0),
               (1, 10, 1, 2500, 2500, 256, True, 300, 10.0),
               (2, 6, 1, 500, 700, 128, False, 0, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_vs_plain(cuda_device, case, dtype):
    """The three backward kernels against the plain FlashAttention-2
    backward in float32 on the same inputs, on the card: normwise 1e-4 in
    float32 (sums in another order), 2e-2 in bfloat16 (P and dS rounded to
    bfloat16 before their products, and the outputs to bfloat16)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, H, Kh, Sq, Skv, D, causal, window, cap = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(Sq * D + H)
    q = torch.randn(B, H, Sq, D, generator=gen, device=cuda_device).to(dt)
    k, v = (torch.randn(B, Kh, Skv, D, generator=gen,
                        device=cuda_device).to(dt) for _ in range(2))
    do = torch.randn(B, H, Sq, D, generator=gen, device=cuda_device).to(dt)
    kw = dict(causal=causal, window=window, softcap=cap)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    o_ref, lse_ref = ref.attention_ref(q, k, v, return_lse=True, **kw)
    assert _normwise(lse, lse_ref) <= 1e-5
    launches = fa.bwd_launches
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    f32 = [x.float() for x in (q, k, v, o, lse, do)]
    want = ref.attention_bwd_ref(*f32, **kw)
    torch.cuda.synchronize()
    assert fa.bwd_launches == launches + 1
    limit = 1e-4 if dtype == "float32" else 2e-2
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dt and bool(torch.isfinite(x).all())
        err = _normwise(x, y)
        assert err <= limit, f"{name}: normwise {err} > {limit}"


def _bwd_inputs(case, dtype, device, seed):
    B, H, Kh, Sq, Skv, D, causal, window, cap = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, H, Sq, D, generator=gen, device=device).to(dtype)
    k, v = (torch.randn(B, Kh, Skv, D, generator=gen, device=device)
            .to(dtype) for _ in range(2))
    do = torch.randn(B, H, Sq, D, generator=gen, device=device).to(dtype)
    return q, k, v, do, dict(causal=causal, window=window, softcap=cap)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int16 if a.element_size() == 2 else torch.int32),
        b.view(torch.int16 if b.element_size() == 2 else torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_flash_attention_bwd_group_split_vs_plain(cuda_device, case):
    """bfloat16 shapes whose dK/dV grid is short: the group is split over
    blocks (more than one split; reduced in split order), and the result
    is held to the plain backward at 2e-2 normwise as without a split."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    q, k, v, do, kw = _bwd_inputs(case, torch.bfloat16, cuda_device, 21)
    assert fa.bwd_splits(q, k) > 1
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = ref.attention_bwd_ref(
        *(x.float() for x in (q, k, v, o, lse, do)), **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(x).all())
        err = _normwise(x, y)
        assert err <= 2e-2, f"{name}: normwise {err} > 2e-2"


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 10, 1, 4096, 4096, 256, True, 2048,
                                   0.0),
                                  (2, 15, 5, 4096, 4096, 64, True, 0, 0.0),
                                  SPLIT_CASES[0]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_is_deterministic(cuda_device, case, dtype):
    """Two backward calls on the same inputs give the same bits (no
    atomics; a split group is reduced in a fixed order): the training
    shapes of RecurrentGemma-2B (split) and SmolLM-360M, and a split
    case."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do, kw = _bwd_inputs(case, getattr(torch, dtype), cuda_device,
                                  22)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    first = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    second = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert _same_bits(x, y)


@pytest.mark.cuda
def test_autograd_functions_launch_the_backward_kernels(cuda_device):
    """``ops.flash_attention`` and ``ops.decay_scan`` under autograd: one
    forward launch (with the log-sum-exp) and one backward call each, the
    gradients those of the kernels; without a gradient wanted, the forward
    alone and no log-sum-exp."""
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(1, 4, 96, 64, generator=gen, device=cuda_device)
    k, v = (torch.randn(1, 2, 96, 64, generator=gen, device=cuda_device)
            for _ in range(2))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    f0, b0 = fa.launches, fa.bwd_launches
    out = ops.flash_attention(q, k, v, causal=True, window=40)
    do = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert (fa.launches, fa.bwd_launches) == (f0 + 1, b0 + 1)
    o, lse = fa.flash_attention_cuda(q.detach(), k.detach(), v.detach(),
                                     causal=True, window=40,
                                     return_lse=True)
    want = fa.flash_attention_bwd_cuda(q.detach(), k.detach(), v.detach(),
                                       o, lse, do, causal=True, window=40)
    for x, y in zip(grads, want):
        assert _bitwise(x, y)
    with torch.inference_mode():
        ops.flash_attention(q, k, v, causal=True)
    assert (fa.launches, fa.bwd_launches) == (f0 + 3, b0 + 2)

    a = torch.rand(50, 32, generator=gen, device=cuda_device)
    u = torch.randn(50, 32, generator=gen, device=cuda_device)
    a.requires_grad_()
    u.requires_grad_()
    f0, b0 = ds.launches, ds.bwd_launches
    h = ops.decay_scan(a, u)
    g = torch.randn_like(h)
    da, du = torch.autograd.grad(h, (a, u), g)
    assert (ds.launches, ds.bwd_launches) == (f0 + 1, b0 + 1)
    want = ds.decay_scan_bwd_cuda(a.detach(), h.detach(), g)
    assert _bitwise(da, want[0]) and _bitwise(du, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,opt", [("recurrentgemma-2b", "adamw"),
                                      ("smollm-360m", "adafactor"),
                                      ("mamba2-2.7b", "adamw")])
def test_train_step_on_card_matches_cpu(cuda_device, arch, opt):
    """``make_train_step`` on a smoke config on the card, from the same
    float32 state and batch as on the CPU: both backward kernels (or the
    attention one alone) launched as the plan says, and the first steps'
    losses and gradient norms within 1e-4 relative (float32, sums in
    another order; normwise gradient limits as chip phase 12 (b))."""
    import dataclasses

    from repro_torch.configs.base import load_smoke_config
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import trainer

    run = load_smoke_config(arch)
    run = dataclasses.replace(run, train=dataclasses.replace(
        run.train, optimizer=opt, param_dtype="float32",
        compute_dtype="float32", grad_accum=2, warmup_steps=1,
        learning_rate=1e-3))
    cpu = torch.device("cpu")
    state = trainer.init_train_state(run, torch.Generator().manual_seed(0),
                                     device=cpu)
    card = trainer.TrainState(
        step=state.step.to(cuda_device),
        params=tree_map(lambda p: p.detach().to(cuda_device)
                        .requires_grad_(), state.params),
        master=None, opt=tree_map(lambda x: x.to(cuda_device), state.opt),
        sync=None)
    batch = synthetic_batch(run.model, np.random.default_rng(1), 4, 128)
    step = trainer.make_train_step(run, total_steps=10)
    f0 = (ds.launches, ds.bwd_launches, fa.launches, fa.bwd_launches)
    for _ in range(3):
        state, m_cpu = step(state, batch)
        card, m_card = step(card, {k: v.to(cuda_device)
                                   for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            assert abs(float(m_card[k]) - float(m_cpu[k])) <= \
                1e-4 * abs(float(m_cpu[k])), k
    torch.cuda.synchronize()
    counts = (ds.launches - f0[0], ds.bwd_launches - f0[1],
              fa.launches - f0[2], fa.bwd_launches - f0[3])
    kinds = ("rec", "ssd")
    from repro_torch.models import backbone
    plan = backbone.layer_plan(run.model)
    scans = sum(k in kinds for k in plan.kinds)
    attns = sum(k in ("attn", "moe", "cross") for k in plan.kinds)
    scan_groups = sum(k in kinds for k in plan.pattern) * plan.n_groups
    attn_groups = sum(k in ("attn", "moe", "cross")
                      for k in plan.pattern) * plan.n_groups
    want = (3 * 2 * (scans + scan_groups), 3 * 2 * scans,
            3 * 2 * (attns + attn_groups), 3 * 2 * attns)
    assert counts == want
    assert all(p.device.type == "cuda" for p in tree_leaves(card))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ht", "ef"])
def test_thinned_sync_on_card_matches_cpu(cuda_device, mode):
    """The thinned gradient sync on the card: each leaf's uniforms (the
    bits of jax.random's split + uniform, which the CPU tests hold to
    JAX) bitwise equal to the CPU's, drawn on the card, for odd block
    counts and one block; the same blocks kept and the synced gradients
    within 1e-5 normwise (the block RMS reductions sum in another
    order)."""
    from repro_torch.kernels import threefry
    from repro_torch.train import compression

    for seed in (0, 7, 2**31 - 1):
        key = threefry.prng_key(seed)
        for n in (1, 3, 1000, 4097):
            got = threefry.uniform(key, n, cuda_device)
            assert got.device == cuda_device
            assert _bitwise(got, threefry.uniform(key, n))
    rng = np.random.default_rng(5)
    host = [torch.tensor(rng.normal(size=s).astype(np.float32)
                         * rng.uniform(0.1, 10.0, size=s[-1:]))
            for s in [(300, 1024), (4097,), (7, 3), (1,)]]
    card = [g.to(cuda_device) for g in host]
    cfg = compression.ThinnedSyncConfig(mode=mode)
    key = threefry.prng_key(11)
    got, _, m_card = compression.thin_gradients(
        card, compression.init_state(card), key, cfg)
    want, _, m_cpu = compression.thin_gradients(
        host, compression.init_state(host), key, cfg)
    assert float(m_card["sync_volume_fraction"]) == \
        float(m_cpu["sync_volume_fraction"])
    for g, w in zip(got, want):
        assert g.device == cuda_device
        err = float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(
            1e-30))
        assert err <= 1e-5
