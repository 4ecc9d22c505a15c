"""repro_torch on a CUDA device: the hand-written kernel and the engine.

These tests need a GPU (a CUDA kernel has no CPU mode) and skip without
one; they import no JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel is held bitwise to its plain PyTorch version on the CPU, which
``test_torch_kernels.py`` holds bitwise to the JAX reference; the engine on
the card is held bitwise to the engine on the CPU in exact mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (EngineConfig, init_state, prng_key,  # noqa: E402
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
    launches = trmw.launches
    (gs, gi), (gs2, _), (cs, ci) = (run(cuda_device), run(cuda_device),
                                    run("cpu"))
    n_blocks = -(-n // batch)
    if mode == "fast":
        assert trmw.launches - launches == 2 * n_blocks
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
