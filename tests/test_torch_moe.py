"""repro_torch's mixture of experts and MoE family against the JAX package.

``ffn.moe`` on the same inputs and weights as JAX ``ffn.moe`` (numpy
draws, constant leaves perturbed), and the smoke configs of
``qwen2-moe-a2.7b`` (6 experts padded to 8, top-2, 2 shared) and
``kimi-k2-1t-a32b`` (a dense first layer, 8 experts, top-2, 1 shared), in
float32 on the CPU, with the JAX package's random weights carried over by
``from_jax_params``.  Tolerances, with their reasons:

* Expert ids: equal.  The router is float32 on both sides; a flip between
  the two would need two probabilities within a few ulps, and the failure
  message reports the gap of each flipped token.
* The keep set (which choices fit their expert's capacity) and
  ``moe_drop_frac``: equal.  Both sort the choices stably by expert id.
* ``y``: rtol = atol = 1e-5.  The same products summed in another order
  (the combine sums a token's k choices where JAX scatter-adds them).
* aux and z losses: rtol 1e-6.  Means over the tokens in another order.
* Prefill and decode logits and the KV caches: rtol = atol = 5e-4, as the
  dense family (two or three layers of GEMMs summed in another order).
  The smoke prompts stay under the capacity floor of 256 tokens, so no
  choice drops on either side.
* Greedy ``generate``: equal tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import base as jbase                       # noqa: E402
from repro.models import backbone as jbb                      # noqa: E402
from repro.models import common as jcommon                    # noqa: E402
from repro.models import ffn as jffn                          # noqa: E402
from repro.serving import engine as jengine                   # noqa: E402
from repro_torch.configs import base                          # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.models import backbone, common, ffn          # noqa: E402
from repro_torch.serving import engine                        # noqa: E402
from test_torch_dense import (_np, carried_model, jax_caches,  # noqa: E402
                              jax_layers, perturb_constants)

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]
Y_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-6, atol=0)
LOGITS_TOL = dict(rtol=5e-4, atol=5e-4)
# (num_experts, padded, top_k, shared, capacity_factor, deterministic cap)
MOE_CASES = {
    "no_drops": (8, 8, 2, 0, 8.0, None),
    "padded": (6, 8, 2, 0, 1.25, None),
    "shared": (8, 8, 2, 2, 1.25, None),
    "forced_drops": (8, 8, 2, 0, 1.25, 3),
    "forced_drops_padded_shared": (6, 8, 3, 1, 1.25, 5),
}
D, F, B, S = 32, 16, 2, 16


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def moe_inputs(E_pad, shared, seed=0):
    """(JAX tree, port tree, x) for ``ffn.moe_specs(D, F, E_pad, shared)``:
    the JAX init, constants perturbed, and x [B, S, D], all from seeds."""
    jp = jcommon.init_tree(jffn.moe_specs(D, F, E_pad, shared),
                           jax.random.PRNGKey(seed), jnp.float32)
    np_p = perturb_constants(jp, seed + 100)
    x = np.random.default_rng(seed + 1).normal(size=(B, S, D)).astype(
        np.float32)
    return jax.tree.map(jnp.asarray, np_p), _tensors(np_p), x


def jax_route(jp, x, num_experts, top_k):
    """The reference router's probabilities and expert ids (the first
    lines of ``repro.models.ffn.moe``)."""
    xf = jnp.asarray(x).reshape(-1, D)
    logits = jnp.einsum("td,de->te", xf, jp["router"])
    E_pad = logits.shape[1]
    if E_pad > num_experts:
        logits = jnp.where((jnp.arange(E_pad) >= num_experts)[None],
                           -1e30, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    return np.asarray(probs), np.asarray(jax.lax.top_k(probs, top_k)[1])


def jax_keep(eid, cap):
    """The reference's keep mask in sorted order (``ffn.moe``'s dispatch
    lines) and its sort order."""
    flat_e = jnp.asarray(eid).reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    idx = jnp.arange(flat_e.size)
    is_start = jnp.concatenate([jnp.array([True]),
                                sorted_e[1:] != sorted_e[:-1]])
    seg_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    return np.asarray(idx - seg_start < cap), np.asarray(order)


def assert_same_experts(eid, want, probs, top_k):
    """Equal expert ids; on a flip, the failure names each flipped token
    and the gap between its k-th and (k+1)-th probability."""
    bad = np.nonzero((eid != want).any(-1))[0]
    gaps = {int(t): float(np.sort(probs[t])[::-1][top_k - 1]
                          - np.sort(probs[t])[::-1][top_k])
            for t in bad}
    assert not len(bad), f"routing flips at tokens (gap) {gaps}"


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_jax(case):
    n_exp, E_pad, k, shared, cf, det = MOE_CASES[case]
    jp, p, x = moe_inputs(E_pad, shared)
    kw = dict(num_experts=n_exp, top_k=k, capacity_factor=cf,
              deterministic_capacity=det)
    want, wm = jffn.moe(jp, jnp.asarray(x), **kw)
    got, m = ffn.moe(p, torch.tensor(x), **kw)

    probs, want_eid = jax_route(jp, x, n_exp, k)
    _, eid, _, _ = ffn.route(torch.tensor(x).reshape(-1, D), p["router"],
                             n_exp, k)
    assert_same_experts(_np(eid), want_eid, probs, k)
    assert (want_eid < n_exp).all()         # padding never routed
    cap = det if det is not None else ffn.capacity(B * S, k, n_exp, cf)
    order, _, _, keep = ffn.sort_slots(eid, cap)
    want_keep, want_order = jax_keep(want_eid, cap)
    np.testing.assert_array_equal(_np(order), want_order)
    np.testing.assert_array_equal(_np(keep), want_keep)
    assert (det is not None) == (not want_keep.all())   # drops only forced

    np.testing.assert_allclose(_np(got), np.asarray(want), **Y_TOL)
    assert float(m["moe_drop_frac"]) == float(wm["moe_drop_frac"])
    for name in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(m[name]), float(wm[name]),
                                   err_msg=name, **LOSS_TOL)


def test_moe_ties_go_to_the_lower_expert():
    """Equal router probabilities pick the lower expert ids, as
    ``jax.lax.top_k`` does: a zero router makes every expert tie."""
    jp, p, x = moe_inputs(8, 0)
    p["router"] = torch.zeros_like(p["router"])
    _, eid, _, _ = ffn.route(torch.tensor(x).reshape(-1, D), p["router"],
                             6, 3)
    _, want = jax_route({"router": jnp.zeros((D, 8))}, x, 6, 3)
    np.testing.assert_array_equal(_np(eid), want)
    assert (_np(eid) == [0, 1, 2]).all()


@pytest.mark.parametrize("slab", [1 << 30, 12, 24])
def test_init_param_draws_a_matrix_slab_by_slab(slab, monkeypatch):
    """A matrix leaf is drawn in slabs of whole leading rows of at most
    ``SLAB_ELEMENTS`` float32 numbers each (Kimi-K2's expert leaf [384,
    7168, 2048] would be 22.5 GB of float32 drawn whole): one slab when it
    fits, the same numbers as a whole draw from the seed; else the seed's
    draws of 1 or 2 rows each, in order.  Exact equality: the same draws
    at the same scale, cast once."""
    monkeypatch.setattr(common, "SLAB_ELEMENTS", slab)
    spec = common.Spec((5, 3, 4), fan_in=16)
    got = common.init_param(spec, torch.Generator().manual_seed(0),
                            torch.bfloat16, "cpu")
    gen = torch.Generator().manual_seed(0)
    rows = min(5, slab // 12)
    want = torch.cat([torch.randn((min(rows, 5 - i), 3, 4), generator=gen)
                      for i in range(0, 5, rows)]) * 0.25
    assert torch.equal(got, want.to(torch.bfloat16))


# ------------------------------------------------------------- the family
@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jrun = jbase.load_smoke_config(request.param)
    jparams, run, params = carried_model(jrun)
    return jrun, jparams, run, params


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("loader", ["load_config", "load_smoke_config"])
def test_config_copy_matches_jax(arch, loader):
    got = getattr(base, loader)(arch).model
    want = getattr(jbase, loader)(arch).model
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), \
            field.name
    got.validate()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_param_counts_equal_jax(arch):
    cfg, jcfg = base.load_config(arch).model, jbase.load_config(arch).model
    assert backbone.count_params(cfg) == jbb.count_params(jcfg)
    assert backbone.active_params(cfg) == jbb.active_params(jcfg)
    assert backbone.active_params(cfg) < backbone.count_params(cfg)
    plan = backbone.layer_plan(cfg)
    assert plan.kinds == ("attn",) * cfg.first_dense_layers + \
        ("moe",) * (cfg.num_layers - cfg.first_dense_layers)


def test_carry_over_copies_every_expert_leaf(model):
    jrun, jparams, run, params = model
    jl = jax_layers(jparams, jbb.layer_plan(jrun.model))
    assert len(jl) == len(params["layers"])
    for layer, jlayer in zip(params["layers"], jl):
        want = {".".join(k.key for k in path): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(jlayer)[0]}
        got = dict(layer.named_parameters())
        assert sorted(got) == sorted(want)
        for name, p in got.items():
            np.testing.assert_array_equal(_np(p), np.asarray(want[name]),
                                          err_msg=name)
    cfg = run.model
    moe = params["layers"][-1]["moe"]
    assert tuple(moe["w_gate"].shape) == (cfg.num_experts_padded,
                                          cfg.d_model, cfg.moe_d_ff)


def _assert_caches_close(caches, jcaches):
    assert len(caches) == len(jcaches)
    for c, jc in zip(caches, jcaches):
        for name, a, b in zip(c._fields, c, jc):
            np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name,
                                       **LOGITS_TOL)


def test_prefill_matches_jax_with_one_attention_per_layer(model,
                                                          monkeypatch):
    jrun, jparams, run, params = model
    tokens = _tokens(run.model, 2, 40, 3)
    wlogits, wstate = jbb.prefill(jparams, jrun.model,
                                  {"tokens": jnp.asarray(tokens)},
                                  max_len=48, compute_dtype=jnp.float32,
                                  cache_dtype=jnp.float32)
    calls = []
    flash = ops.flash_attention

    def counted(*a, **kw):
        calls.append(kw)
        return flash(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    metrics = []
    logits, state = backbone.prefill(params, run.model,
                                     torch.tensor(tokens), max_len=48,
                                     compute_dtype=torch.float32,
                                     cache_dtype=torch.float32,
                                     layer_metrics=metrics)
    assert len(calls) == run.model.num_layers
    assert all(kw["causal"] for kw in calls)
    np.testing.assert_allclose(_np(logits), np.asarray(wlogits),
                               **LOGITS_TOL)
    assert state.pos == int(wstate.pos) == 40
    _assert_caches_close(state.layers, jax_caches(jrun.model, wstate))
    kinds = backbone.layer_plan(run.model).kinds
    assert [float(m["moe_drop_frac"]) for m in metrics] == [0.0] * len(kinds)


def test_forward_metrics_match_jax(model):
    """The sums over layers of the MoE losses and drop fractions, which
    the reference's ``forward_hidden`` returns (within 1e-6 absolute as
    well: the reference's scanned sum of drop fractions that are all 0
    comes out at -6e-8)."""
    jrun, jparams, run, params = model
    tokens = _tokens(run.model, 2, 24, 6)
    wh, wm = jbb.forward_hidden(jparams, jrun.model,
                                {"tokens": jnp.asarray(tokens)},
                                compute_dtype=jnp.float32)
    metrics = []
    h = backbone.forward_hidden(params, run.model, torch.tensor(tokens),
                                compute_dtype=torch.float32,
                                layer_metrics=metrics)
    np.testing.assert_allclose(_np(h), np.asarray(wh), **LOGITS_TOL)
    for name in ("moe_aux_loss", "moe_z_loss", "moe_drop_frac"):
        got = sum(float(m[name]) for m in metrics)
        np.testing.assert_allclose(got, float(wm[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_decode_steps_match_jax(model):
    """Prompt 30, then 8 steps (the decode's own MoE over 2 tokens)."""
    jrun, jparams, run, params = model
    tokens = _tokens(run.model, 2, 38, 4)
    _, wstate = jbb.prefill(jparams, jrun.model,
                            {"tokens": jnp.asarray(tokens[:, :30])},
                            max_len=38, compute_dtype=jnp.float32,
                            cache_dtype=jnp.float32)
    _, state = backbone.prefill(params, run.model,
                                torch.tensor(tokens[:, :30]), max_len=38,
                                compute_dtype=torch.float32,
                                cache_dtype=torch.float32)
    for t in range(30, 38):
        tok = tokens[:, t:t + 1]
        wlogits, wstate = jbb.decode_step(jparams, jrun.model, wstate,
                                          jnp.asarray(tok),
                                          compute_dtype=jnp.float32)
        logits, state = backbone.decode_step(params, run.model, state,
                                             torch.tensor(tok),
                                             compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(logits), np.asarray(wlogits),
                                   err_msg=f"position {t}", **LOGITS_TOL)
    _assert_caches_close(state.layers, jax_caches(jrun.model, wstate))


def test_greedy_generate_tokens_equal_jax(model):
    jrun, jparams, run, params = model
    prompt = _tokens(run.model, 2, 24, 5)
    want = jengine.generate(jrun, jparams, jnp.asarray(prompt),
                            max_new_tokens=10)
    got = engine.generate(run, params, torch.tensor(prompt),
                          max_new_tokens=10)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
