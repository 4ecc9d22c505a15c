"""repro_torch's decay_scan and flash_attention against the JAX package.

On the CPU the wrappers run the plain PyTorch versions
(``repro_torch.kernels.ref``); the same numpy inputs go through the JAX
package's Pallas kernels in interpret mode and its jnp oracles.  The
tolerances are the JAX suite's own (``tests/test_kernels.py``): 1e-5 for
the scan (the port's loop and ``lax.scan`` may round the multiply-add
differently), 2e-4 for float32 attention and 5e-2 for bfloat16 (the
oracle normalises before rounding the weights to bfloat16, the online
softmax after).  The CUDA cases hold each kernel against its plain version
on the card, bfloat16 attention to two ulps of each value plus 2^-7 of
the largest value of its query row; they need a card and skip without
one, and they need no JAX (the JAX package is imported only by the
``jx`` fixture), so they run on a machine that has only PyTorch:

PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_scan_attention.py
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decay_scan as ds               # noqa: E402
from repro_torch.kernels import flash_attention as fa          # noqa: E402
from repro_torch.kernels import ops, ref                       # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernel wrappers and oracles."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return types.SimpleNamespace(jnp=jnp, ops=jops, ref=jref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _scan_inputs(T, C, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (T, C)).astype(np.float32)
    u = rng.normal(size=(T, C)).astype(np.float32)
    h0 = rng.normal(size=(C,)).astype(np.float32)
    return a, u, h0


# ------------------------------------------------------------- decay_scan
@pytest.mark.parametrize("T,C", [(8, 16), (100, 130), (7, 384)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_decay_scan_matches_jax(jx, T, C, with_h0):
    jnp = jx.jnp
    a, u, h0 = _scan_inputs(T, C, [T, C])
    h0 = h0 if with_h0 else None
    got = ops.decay_scan(torch.tensor(a), torch.tensor(u),
                         None if h0 is None else torch.tensor(h0)).numpy()
    jh0 = None if h0 is None else jnp.asarray(h0)
    pallas = jx.ops.decay_scan(jnp.asarray(a), jnp.asarray(u), jh0,
                               use_pallas="interpret", block_t=32,
                               block_c=128)
    oracle = jx.ref.decay_scan_ref(jnp.asarray(a), jnp.asarray(u), jh0)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_decay_scan_zero_decay_is_cumsum():
    u = np.random.default_rng(0).normal(size=(32, 8)).astype(np.float32)
    got = ops.decay_scan(torch.ones(32, 8), torch.tensor(u))
    np.testing.assert_allclose(got.numpy(), np.cumsum(u, 0), rtol=1e-5,
                               atol=1e-5)


# -------------------------------------------------------- flash_attention
SHAPES = [(2, 4, 4, 64, 64, 32),     # MHA
          (2, 4, 2, 64, 64, 64),     # GQA
          (1, 8, 1, 128, 128, 64),   # MQA
          (2, 4, 2, 96, 96, 64)]     # ragged S
MASKS = [(True, 0, 0.0), (True, 32, 0.0), (True, 0, 20.0), (False, 0, 0.0)]


def _attn_inputs(B, H, Kh, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Kh, Skv, D)).astype(np.float32),
            rng.normal(size=(B, Kh, Skv, D)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,window,softcap", MASKS)
def test_flash_attention_matches_jax_oracle(jx, shape, causal, window,
                                           softcap):
    """The whole grid of ``tests/test_kernels.py`` against the jnp oracle
    (the non-causal ragged case too: the port masks the edge itself)."""
    jnp = jx.jnp
    q, k, v = _attn_inputs(*shape, seed=list(shape) + [window])
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), **kw)
    want = jx.ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("shape,causal,window,softcap", [
    ((2, 4, 2, 64, 64, 64), True, 0, 0.0),
    ((1, 8, 1, 128, 128, 64), True, 32, 0.0),
    ((2, 4, 2, 96, 96, 64), True, 0, 20.0),
    ((2, 4, 4, 64, 64, 32), False, 0, 0.0),
])
def test_flash_attention_matches_pallas_interpret(jx, shape, causal, window,
                                                  softcap):
    jnp = jx.jnp
    q, k, v = _attn_inputs(*shape, seed=list(shape) + [window])
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), **kw)
    want = jx.ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), use_pallas="interpret",
                                  block_q=32, block_k=32, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_dtypes(jx, dtype):
    q, k, v = _attn_inputs(1, 2, 2, 64, 64, 32, seed=11)
    jnp = jx.jnp
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = ops.flash_attention(*(torch.tensor(x).to(tdt) for x in (q, k, v)))
    assert got.dtype == tdt
    want = jx.ops.flash_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), use_pallas="interpret",
        block_q=32, block_k=32)
    tol = 5e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# --------------------------------------------------------- wrapper checks
def test_kernel_entry_points_refuse_cpu_tensors():
    a = torch.rand(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ds.decay_scan_cuda(a, a)
    q = torch.rand(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q[:, :1], q[:, :1])


@pytest.mark.parametrize("case", [
    "f64", "shape", "h0_shape", "h0_dtype", "three_dims"])
def test_decay_scan_refuses_what_the_kernel_does_not_take(case):
    a, u, h0 = torch.rand(6, 5), torch.rand(6, 5), torch.rand(5)
    if case == "f64":
        a, u = a.double(), u.double()
    elif case == "shape":
        u = torch.rand(6, 4)
    elif case == "h0_shape":
        h0 = torch.rand(6)
    elif case == "h0_dtype":
        h0 = h0.half()
    else:
        a, u = a[None], u[None]
    with pytest.raises(ValueError, match="decay_scan"):
        ops.decay_scan(a, u, h0)


@pytest.mark.parametrize("case", [
    "f16", "mixed", "kv_shape", "groups", "head_dim", "no_keys", "window"])
def test_flash_attention_refuses_what_the_kernel_does_not_take(case):
    q, k, v = torch.rand(1, 4, 8, 16), torch.rand(1, 2, 8, 16), \
        torch.rand(1, 2, 8, 16)
    kw = {}
    if case == "f16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed":
        k = k.bfloat16()
    elif case == "kv_shape":
        v = torch.rand(1, 2, 9, 16)
    elif case == "groups":
        k, v = torch.rand(1, 3, 8, 16), torch.rand(1, 3, 8, 16)
    elif case == "head_dim":
        q, k, v = (torch.rand(1, x, 8, 288) for x in (4, 2, 2))
    elif case == "no_keys":
        k, v = torch.rand(1, 2, 0, 16), torch.rand(1, 2, 0, 16)
    else:
        kw = dict(window=-1)
    with pytest.raises(ValueError, match="flash_attention"):
        ops.flash_attention(q, k, v, **kw)


# ------------------------------------------------- kernels on a CUDA card
def _bf16_ratio(got, want):
    """The largest |got - want| over the bf16 limit: two ulps of each value
    plus 2^-7 of its row's largest value."""
    got, want = got.float().cpu(), want.float().cpu()
    limit = 2.0 ** -6 * want.abs() + \
        2.0 ** -7 * want.abs().amax(-1, keepdim=True)
    return float(((got - want).abs() / limit).max())


@pytest.mark.cuda
@pytest.mark.parametrize("T,C", [
    (1, 1), (7, 100), (256, 2560), (33, 5120),
    # many ring stages, a ragged last stage (T not a multiple of the stage
    # length) and a ragged channel edge (C not a multiple of the block's
    # width, or of 4, which takes the copy path instead of TMA)
    (4096, 2560), (4096, 5120), (1000, 2600), (4097, 33)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_decay_scan_kernel_bitwise_vs_plain(cuda_device, T, C, with_h0):
    a, u, h0 = (torch.tensor(x, device=cuda_device)
                for x in _scan_inputs(T, C, [T, C, 1]))
    h0 = h0 if with_h0 else None
    launches = ds.launches
    got = ops.decay_scan(a, u, h0)
    want = ref.decay_scan_ref(a, u, h0)
    torch.cuda.synchronize()
    assert ds.launches == launches + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(1, 10, 1, 300, 300, 256)])
@pytest.mark.parametrize("causal,window,softcap", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_vs_plain(cuda_device, shape, causal, window,
                                         softcap, dtype):
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(x, device=cuda_device).to(tdt) for x in
               _attn_inputs(*shape, seed=list(shape) + [window]))
    kw = dict(causal=causal, window=window, softcap=softcap)
    launches = fa.launches
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == launches + 1
    if dtype == "bfloat16":
        ratio = _bf16_ratio(got, want)
        assert ratio <= 1.0, f"error at {ratio} of the limit"
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,softcap,offset", [
    ((2, 4, 2, 100, 100, 40), True, 0, 0.0, 0),      # D % 16 != 0, TMA
    ((1, 4, 1, 130, 130, 33), True, 48, 10.0, 0),    # odd D: copied tiles
    ((2, 4, 2, 96, 64 * 5 + 7, 64), True, 48, 0.0, 0),   # Sq < Skv, window
    ((1, 4, 2, 70, 70, 64), False, 0, 0.0, 1),       # unaligned: copied
    ((2, 10, 1, 4096, 4096, 256), True, 2048, 0.0, 0),   # serving, batch 2
])
def test_flash_attention_bf16_tensor_core_cases(cuda_device, shape, causal,
                                                window, softcap, offset):
    B, H, Kh, Sq, Skv, D = shape
    qkv = []
    for x in _attn_inputs(*shape, seed=list(shape) + [window, offset]):
        flat = torch.empty(x.size + offset, dtype=torch.bfloat16,
                           device=cuda_device)
        t = flat[offset:].view(x.shape)     # contiguous, `offset` elements in
        t.copy_(torch.tensor(x))
        qkv.append(t)
    kw = dict(causal=causal, window=window, softcap=softcap)
    launches = fa.launches
    got = ops.flash_attention(*qkv, **kw)
    want = ref.attention_ref(*qkv, **kw)
    torch.cuda.synchronize()
    assert fa.launches == launches + 1
    assert bool(torch.isfinite(got).all())
    ratio = _bf16_ratio(got, want)
    assert ratio <= 1.0, f"error at {ratio} of the limit"
