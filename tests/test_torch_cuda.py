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
