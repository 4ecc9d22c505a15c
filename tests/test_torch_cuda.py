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
