"""repro_torch's expert-parallel MoE (``models/moe_ep.py``): gloo ranks on
the CPU, one process a mesh device (``distributed.spawn.run_ranks``),
held against the JAX package run in the test process.

The JAX ``moe_ep`` test on an 8-device mesh is one of the reference's
faults under jax 0.9 (ROADMAP.md queue 3), so, as the reference test
does, the ranks are held against the dense JAX ``ffn.moe`` at
``capacity_factor = 8``, where neither drops a choice: on 2 ranks
(``("model",)``), 4 ranks (``("model",)``) and 2 x 2 ranks (``("data",
"model")``).  The EP capacity rule (a floor of 8, rounded up to 8) and
its drops are held against the JAX ``moe_ep`` itself on a one-device
mesh, which jax 0.9 runs.  The ranks import no JAX: they unpickle this
module's rank functions, so the module imports JAX only inside the tests
(the ``jx`` fixture).  Every spawn is bounded by ``TIMEOUT_S``.

Tolerances, with their reasons:

* ``y``: rtol = atol = 1e-5.  The experts see their tokens in another
  order and the combine sums a token's k choices where JAX scatter-adds
  them; nothing amplifies the difference.
* ``moe_drop_frac``: equal (0 at ``capacity_factor = 8``; the one-device
  comparison drops the same choices).
* z loss: rtol 1e-5 (a mean of per-rank means of equal-sized chunks).
  The aux loss is a product of means, which the reference's ``moe_ep``
  also averages per chunk, so it is compared with JAX ``moe_ep`` only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed.context import get_mesh, mesh_context  # noqa
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.models import backbone, ffn, moe_ep  # noqa: E402

TIMEOUT_S = 60.0
E, D, F, K = 8, 32, 16, 2
B, S = 4, 16
Y_TOL = dict(rtol=1e-5, atol=1e-5)


def _data(seed=0, E_pad=E):
    """The MoE tree (numpy leaves) and x [B, S, D] from numpy seeds: the
    router, the experts and the shared expert and its gate all drawn."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    p = {"router": w(D, E_pad), "w_gate": w(E_pad, D, F),
         "w_up": w(E_pad, D, F), "w_down": w(E_pad, F, D),
         "shared": {"w_up": w(D, 2 * F), "w_gate": w(D, 2 * F),
                    "w_down": w(2 * F, D)},
         "shared_gate": w(D, 1)}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return p, x


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.tensor(tree)


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


# ------------------------------------------------------------ rank bodies
def _ep_meshes(mesh, p_np, x_np, meshes):
    """On every rank: ``moe_ep`` on each (model, data) mesh at cf 8 and
    1.25, with the full tree and with the rank's share of it."""
    from repro_torch.launch.mesh import make_model_mesh

    p, x = _tensors(p_np), torch.tensor(x_np)
    out = {}
    for name, (model, data) in meshes.items():
        m = make_model_mesh(model, data, device="cpu")
        before = collectives.all_to_all_calls
        y, met = moe_ep.moe_ep(p, x, num_experts=E, top_k=K,
                               capacity_factor=8.0, mesh=m)
        calls = collectives.all_to_all_calls - before
        y_loc, _ = moe_ep.moe_ep(moe_ep.local_experts(p, m), x,
                                 num_experts=E, top_k=K, capacity_factor=8.0,
                                 mesh=m)
        _, met_125 = moe_ep.moe_ep(p, x, num_experts=E, top_k=K, mesh=m)
        out[name] = {"y": y.numpy(), "metrics": _metrics(met),
                     "calls": calls, "local_equal": torch.equal(y, y_loc),
                     "drop_125": float(met_125["moe_drop_frac"]),
                     "dims": tuple(m.mesh_dim_names)}
    return out


def _ep_fallbacks(mesh, p_np, x_np):
    """On 2 ranks: the fallbacks to the dense ``ffn.moe`` (a mesh without
    a ``"model"`` dim; S that ``"model"`` does not divide; none of them
    communicates), the refusal to fall back with a rank's share, and
    ``apply_block`` routing to ``moe_ep`` under ``moe_impl="ep_a2a"``."""
    import dataclasses

    from repro_torch.configs.base import load_smoke_config
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models import common

    p, x = _tensors(p_np), torch.tensor(x_np)
    kw = dict(num_experts=E, top_k=K, capacity_factor=8.0)
    res = {}
    before = collectives.all_to_all_calls
    dense, _ = ffn.moe(p, x, **kw)
    res["no_model_dim"] = torch.equal(
        moe_ep.moe_ep(p, x, mesh=mesh, **kw)[0], dense)
    m = make_model_mesh(2, device="cpu")
    odd = x[:, :S - 1]
    res["indivisible_s"] = torch.equal(
        moe_ep.moe_ep(p, odd, mesh=m, **kw)[0], ffn.moe(p, odd, **kw)[0])
    res["fallback_calls"] = collectives.all_to_all_calls - before
    try:
        moe_ep.moe_ep(moe_ep.local_experts(p, m), odd, mesh=m, **kw)
        res["refused_local"] = False
    except ValueError:
        res["refused_local"] = True

    cfg = load_smoke_config("qwen2-moe-a2.7b").model
    gen = torch.Generator().manual_seed(3)
    blk = common.Params(common.init_tree(backbone.block_specs("moe", cfg),
                                         gen, torch.float32, "cpu"))
    h = torch.randn(2, 8, cfg.d_model, generator=gen)
    pos = torch.arange(8)
    ep = dataclasses.replace(cfg, moe_impl="ep_a2a")
    want, wm, _ = backbone.apply_block("moe", blk, h, cfg, pos)
    before = collectives.all_to_all_calls
    with mesh_context(m):
        got, gm, _ = backbone.apply_block("moe", blk, h, ep, pos)
    res["block_calls"] = collectives.all_to_all_calls - before
    res["block_err"] = float((got - want).abs().max())
    res["block_drop"] = (float(gm["moe_drop_frac"]),
                         float(wm["moe_drop_frac"]))
    res["mesh_after"] = get_mesh() is None
    return res


def _ep_one_device(mesh, p_np, x_np, cf):
    """On 1 rank: ``moe_ep`` on a one-device ``("model",)`` mesh at ``cf``
    (the EP capacity rule with M = 1)."""
    from repro_torch.launch.mesh import make_model_mesh

    p, x = _tensors(p_np), torch.tensor(x_np)
    m = make_model_mesh(1, device="cpu")
    y, met = moe_ep.moe_ep(p, x, num_experts=E - 2, top_k=K,
                           capacity_factor=cf, mesh=m)
    return {"y": y.numpy(), "metrics": _metrics(met)}


# ------------------------------------------------------------------ tests
@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from repro.models import ffn as jffn
    from repro.models import moe_ep as jmoe_ep
    return jax, jnp, jffn, jmoe_ep


@pytest.fixture(scope="module")
def four_ranks():
    p, x = _data()
    meshes = {"model4": (4, 1), "data2_model2": (2, 2)}
    ranks = run_ranks(_ep_meshes, 4, p, x, meshes, device="cpu",
                      timeout_s=TIMEOUT_S)
    return p, x, ranks


def _dense_jax(jx, p, x, cf=8.0):
    jax, jnp, jffn, _ = jx
    y, m = jffn.moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                    num_experts=E, top_k=K, capacity_factor=cf)
    return np.asarray(y), {k: float(v) for k, v in m.items()}


def _check_against_dense(jx, p, x, ranks, name):
    want, wm = _dense_jax(jx, p, x)
    for r, rank in enumerate(ranks):
        got = rank[name]
        np.testing.assert_allclose(got["y"], want, err_msg=f"rank {r}",
                                   **Y_TOL)
        assert got["metrics"]["moe_drop_frac"] == 0.0 == wm["moe_drop_frac"]
        np.testing.assert_allclose(got["metrics"]["moe_z_loss"],
                                   wm["moe_z_loss"], rtol=1e-5)
        assert got["calls"] == 2            # one out, one back
        assert got["local_equal"]
        # every rank returns the same whole y and the same averages
        np.testing.assert_array_equal(got["y"], ranks[0][name]["y"])
        assert got["metrics"] == ranks[0][name]["metrics"]


@pytest.mark.parametrize("name", ["model4", "data2_model2"])
def test_moe_ep_on_4_ranks_matches_dense_jax(jx, four_ranks, name):
    p, x, ranks = four_ranks
    _check_against_dense(jx, p, x, ranks, name)
    dims = {"model4": ("model",), "data2_model2": ("data", "model")}
    assert ranks[0][name]["dims"] == dims[name]


def test_moe_ep_on_2_ranks_matches_dense_jax(jx):
    p, x = _data(1)
    ranks = run_ranks(_ep_meshes, 2, p, x, {"model2": (2, 1)},
                      device="cpu", timeout_s=TIMEOUT_S)
    _check_against_dense(jx, p, x, ranks, "model2")


def test_ep_capacity_rule_drops_as_jax_moe_ep_on_one_device(jx):
    """At cf 0.5 the EP rule (cap = 8 here, where the dense rule's floor
    would give 256) drops choices; the kept set shows in y and the drop
    fraction, both as the JAX ``moe_ep`` on a one-device mesh computes
    them."""
    jax, jnp, _, jmoe_ep = jx
    p, x = _data(2)
    assert moe_ep.ep_capacity(B * S, K, E, 0.5) == 8
    (got,) = run_ranks(_ep_one_device, 1, p, x, 0.5, device="cpu",
                       timeout_s=TIMEOUT_S)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want, wm = jmoe_ep.moe_ep(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              num_experts=E - 2, top_k=K,
                              capacity_factor=0.5, mesh=mesh)
    assert got["metrics"]["moe_drop_frac"] == float(wm["moe_drop_frac"])
    assert got["metrics"]["moe_drop_frac"] > 0.2
    np.testing.assert_allclose(got["y"], np.asarray(want), **Y_TOL)
    for name in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(got["metrics"][name], float(wm[name]),
                                   rtol=1e-5, err_msg=name)


def test_moe_ep_falls_back_to_dense_and_routes_from_apply_block():
    p, x = _data(3)
    ranks = run_ranks(_ep_fallbacks, 2, p, x, device="cpu",
                      timeout_s=TIMEOUT_S)
    for res in ranks:
        assert res["no_model_dim"] and res["indivisible_s"]
        assert res["fallback_calls"] == 0
        assert res["refused_local"]
        assert res["block_calls"] == 2
        assert res["block_err"] < 1e-5
        assert res["block_drop"] == (0.0, 0.0)
        assert res["mesh_after"]


def test_moe_ep_without_a_mesh_is_the_dense_moe():
    p, x = _data(4)
    p, x = _tensors(p), torch.tensor(x)
    assert get_mesh() is None
    kw = dict(num_experts=E, top_k=K)
    y, m = moe_ep.moe_ep(p, x, **kw)
    want, wm = ffn.moe(p, x, **kw)
    assert torch.equal(y, want)
    assert _metrics(m) == _metrics(wm)
