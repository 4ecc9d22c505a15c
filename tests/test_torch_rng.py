"""repro_torch's counter RNG and inclusion policies against JAX.

Thinning decisions are keyed on (entity, time bits) through threefry-2x32;
the port must draw the very uniforms the JAX engine draws, or no decision
could agree.  The standalone inclusion functions (Eq. 2, Eq. 4, fixed
rate) are held to JAX to 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from jax.extend.random import threefry_2x32                  # noqa: E402
from repro.core import thinning as jthin                     # noqa: E402
from repro_torch.core import thinning                        # noqa: E402
from repro_torch.kernels import threefry                     # noqa: E402

SEEDS = [0, 7, 12345, 2**31 - 1, -1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert thinning.prng_key(seed) == tuple(
        int(w) for w in np.asarray(jax.random.PRNGKey(seed)))
    assert thinning.as_key(np.asarray(jax.random.PRNGKey(seed))) == \
        thinning.prng_key(seed)


def test_time_bits_matches_jax():
    t = np.random.default_rng(0).uniform(0, 1e7, 1000).astype(np.float32)
    want = np.asarray(jthin.time_bits(jnp.asarray(t)))
    got = thinning.time_bits(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_bitwise_vs_jax(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    ent = rng.integers(0, 2**31 - 1, 2000).astype(np.int32)
    t = rng.uniform(0, 1e7, 2000).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jthin.uniform_for_events(
        key, jnp.asarray(ent), jthin.time_bits(jnp.asarray(t))))
    got = thinning.uniform_for_events(
        np.asarray(key), torch.from_numpy(ent),
        thinning.time_bits(torch.from_numpy(t))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry2x32_bitwise_vs_jax(seed):
    """The block function itself (moved to ``kernels/threefry.py``, the
    plain version of the kernel's in-kernel draw) against JAX's."""
    rng = np.random.default_rng(seed & 0xFFFF)
    k = rng.integers(0, 2**32, 2, dtype=np.uint32)
    x = rng.integers(0, 2**32, 2000, dtype=np.uint32)
    want = np.asarray(threefry_2x32(jnp.asarray(k), jnp.asarray(x)))
    xs = torch.from_numpy(x.astype(np.int64))
    got = threefry.threefry2x32(int(k[0]), int(k[1]), xs[:1000], xs[1000:])
    np.testing.assert_array_equal(torch.cat(got).numpy(),
                                  want.astype(np.int64))


def test_rng_keeps_its_old_import_path():
    """``core.thinning`` re-exports the RNG that moved to
    ``kernels.threefry``: the same objects under both names."""
    for name in ("prng_key", "as_key", "threefry2x32", "time_bits",
                 "uniform_for_events"):
        assert getattr(thinning, name) is getattr(threefry, name), name


def test_uniforms_count_cuda_calls_only():
    """``cuda_calls`` counts calls on CUDA tensors; CPU calls leave it."""
    before = threefry.cuda_calls
    thinning.uniform_for_events((0, 1), torch.arange(4),
                                thinning.time_bits(torch.zeros(4)))
    assert threefry.cuda_calls == before


@pytest.mark.parametrize("policy", ["naive", "variance_aware", "fixed"])
def test_inclusion_policies_match_jax(policy):
    rng = np.random.default_rng(4)
    lam = rng.lognormal(-6, 2, 500).astype(np.float32)
    w, mu = (rng.lognormal(3, 1, 500).astype(np.float32) for _ in range(2))
    sigma = rng.uniform(0, 20, 500).astype(np.float32)
    t = lambda x: torch.from_numpy(x)
    if policy == "naive":
        want = jthin.naive_inclusion(jnp.asarray(lam), 0.002)
        got = thinning.naive_inclusion(t(lam), 0.002)
    elif policy == "variance_aware":
        want = jthin.variance_aware_inclusion(
            jnp.asarray(lam), 0.002, jnp.asarray(w), jnp.asarray(mu),
            jnp.asarray(sigma), 1.5)
        got = thinning.variance_aware_inclusion(t(lam), 0.002, t(w), t(mu),
                                                t(sigma), 1.5)
    else:
        want = jthin.fixed_rate_inclusion((500,), 0.3)
        got = thinning.fixed_rate_inclusion((500,), 0.3, device="cpu")
    # log, log1p and sigmoid are not correctly rounded in either library;
    # Eq. 4's logit composition amplifies their ulps near p = min_p
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert float(got.min()) >= np.float32(1e-6) and float(got.max()) <= 1.0
