"""repro_torch's fused thinning_rmw against the JAX reference.

On the CPU the wrapper runs the plain PyTorch version, which is held
*bitwise* to ``repro.kernels.ops.thinning_rmw(use_pallas=False)`` (the jnp
reference under jit) on all 9 outputs, for all 5 policies, over the
``tests/test_kernels.py`` grid — and to the Pallas body in interpret mode
at that suite's own tolerance.  The CUDA kernel's tests, which need no
JAX, are in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops                       # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.kernels import thinning_rmw as trmw          # noqa: E402
from test_torch_cuda import trmw_inputs                      # noqa: E402

NAMES = ["last_t", "v_f", "agg", "z", "p", "feats", "lam", "v_full",
         "last_t_full"]
POLICIES = ["pp", "pp_vr", "full", "fixed", "unfiltered"]
GRID = [(16, 3), (256, 6), (100, 6), (512, 2), (250, 3)]


def _kw(policy, T):
    return dict(h=3600.0, budget=0.001, alpha=1.5, policy=policy,
                fixed_rate=0.3, mu_tau_index=min(2, T - 1))


def _torch(args, device="cpu"):
    return tuple(torch.tensor(a, device=device) for a in args)


def _assert_bitwise(got, want):
    for g, w, name in zip(got, want, NAMES):
        g = g.cpu().numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=name)


@pytest.mark.parametrize("B,T", GRID)
@pytest.mark.parametrize("policy", POLICIES)
def test_plain_bitwise_vs_jax_reference(B, T, policy):
    rng = np.random.default_rng([B, T, POLICIES.index(policy)])
    args = trmw_inputs(rng, B, T)
    want = jops.thinning_rmw(*args, use_pallas=False, **_kw(policy, T))
    launches = trmw.launches
    got = ops.thinning_rmw(*_torch(args), **_kw(policy, T))
    assert trmw.launches == launches      # CPU tensors never launch
    assert len(got) == len(want) == len(NAMES)
    _assert_bitwise(got, want)


@pytest.mark.parametrize("B,T", GRID)
@pytest.mark.parametrize("policy", POLICIES)
def test_plain_vs_pallas_interpret(B, T, policy):
    rng = np.random.default_rng([B, T, POLICIES.index(policy)])
    args = trmw_inputs(rng, B, T)
    want = jops.thinning_rmw(*args, use_pallas="interpret", block_b=64,
                             **_kw(policy, T))
    got = ops.thinning_rmw(*_torch(args), **_kw(policy, T))
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w, np.float32),
                                   rtol=2e-5, atol=1e-5, err_msg=name)


def test_control_column_semantics():
    """v_full/last_t_full update on every *valid* event, persisted or not;
    fresh sentinel rows start their control column from zero mass."""
    f = lambda *x: torch.tensor(x, dtype=torch.float32)
    last_t = f(-1e38, -1e38, 50.0)
    (new_last_t, _, _, z, _, _, _, new_v_full, new_ltf) = ops.thinning_rmw(
        f(60.0, 3600.0), last_t, torch.zeros(3), torch.zeros(3, 6),
        torch.ones(3), f(100.0, 100.0, 100.0), f(2.0, 2.0, 2.0),
        f(1.0, 0.0, 1.0), f(0.0, 3.0, 5.0), f(-1e38, 40.0, 0.0),
        h=100.0, budget=1.0)
    assert not bool(z.any())
    assert torch.equal(new_last_t, last_t)
    # row 0: fresh control column -> v_full = 1 exactly
    assert float(new_v_full[0]) == 1.0 and float(new_ltf[0]) == 100.0
    # row 1: invalid -> control column unchanged
    assert float(new_v_full[1]) == 3.0 and float(new_ltf[1]) == 40.0
    # row 2: valid warm row -> 1 + e^{-dt/h} * v_full
    np.testing.assert_allclose(float(new_v_full[2]),
                               1.0 + np.exp(-1.0) * 5.0, rtol=1e-6)
    assert float(new_ltf[2]) == 100.0


def test_decision_only_defaults():
    """Omitting the control column defaults it to fresh rows."""
    taus, last_t, v_f, agg, q, t, u, valid, _, _ = _torch(
        trmw_inputs(np.random.default_rng(9), 64, 3))
    full = ops.thinning_rmw(taus, last_t, v_f, agg, q, t, u, valid,
                            torch.zeros(64), torch.full((64,), -1e38),
                            h=600.0, budget=0.01)
    dec = ops.thinning_rmw(taus, last_t, v_f, agg, q, t, u, valid,
                           h=600.0, budget=0.01)
    for a, b, name in zip(full, dec, NAMES):
        assert torch.equal(a, b), name


def test_wrapper_rejects_unknown_policy():
    args = _torch(trmw_inputs(np.random.default_rng(1), 8, 2))
    with pytest.raises(ValueError, match="unknown policy"):
        ops.thinning_rmw(*args, h=600.0, budget=0.01, policy="nope")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version for a CPU tensor."""
    args = _torch(trmw_inputs(np.random.default_rng(2), 8, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        trmw.thinning_rmw_cuda(*args, h=600.0, budget=0.01)


@pytest.mark.parametrize("flush_before", [False, True])
def test_cpu_flush_denormals_restores_caller_settings(flush_before):
    """The plain kernel's CPU guard flushes denormals on one intra-op
    thread, then gives back the caller's flush flag and thread count."""
    from repro_torch.kernels.ref import cpu_flush_denormals

    def flushing():
        return bool((torch.tensor([1e-39]) * 1.0)[0] == 0)

    threads = torch.get_num_threads()
    torch.set_flush_denormal(flush_before)
    try:
        with cpu_flush_denormals(torch.device("cpu")):
            assert flushing() and torch.get_num_threads() == 1
            with cpu_flush_denormals(torch.device("cpu")):   # re-entrant
                assert flushing()
            assert flushing() and torch.get_num_threads() == 1
        assert flushing() == flush_before
        assert torch.get_num_threads() == threads
    finally:
        torch.set_flush_denormal(False)
