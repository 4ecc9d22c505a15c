"""repro_torch's dense family against the JAX package.

The smoke configs of ``qwen3-4b`` (qk-norm, untied head), ``smollm-360m``
(tied embeddings), ``command-r-plus-104b`` (GQA groups of 3) and
``yi-9b`` with ``use_bias=True`` (biases on q, k, v, o and the MLP), in
float32 on the CPU, with the JAX package's random weights carried over by
``from_jax_params``.  JAX initialises biases to zeros and norm scales to
ones, which would leave those paths untested, so every constant leaf is
perturbed (the same numpy draws on both sides) before the carry-over.
Tolerances, with their reasons:

* Attention alone: 1e-4 elementwise.  The port's dense softmax and JAX's
  online one sum in another order; nothing amplifies the difference.
* Prefill and decode logits, and the KV caches: rtol = atol = 5e-4.  Two
  layers of GEMMs summed in another order, no recurrence to amplify it.
* Greedy ``generate``: equal tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import base as jbase                       # noqa: E402
from repro.models import attention as jattn                   # noqa: E402
from repro.models import backbone as jbb                      # noqa: E402
from repro.serving import engine as jengine                   # noqa: E402
from repro_torch.configs import base                          # noqa: E402
from repro_torch.configs.base import RunConfig                # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.models import attention, backbone            # noqa: E402
from repro_torch.models.convert import from_jax_params        # noqa: E402
from repro_torch.serving import engine                        # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["qwen3-4b", "smollm-360m", "command-r-plus-104b", "yi-9b"]
CASES = ["qwen3-4b", "smollm-360m", "command-r-plus-104b", "yi-9b+bias"]
ATTN_TOL = dict(rtol=1e-4, atol=1e-4)
LOGITS_TOL = dict(rtol=5e-4, atol=5e-4)
# parameters at full size (``repro.models.backbone.count_params``)
FULL_PARAMS = {"qwen3-4b": 4_411_424_256, "smollm-360m": 361_821_120,
               "yi-9b": 8_829_407_232,
               "command-r-plus-104b": 106_956_337_152}


def perturb_constants(tree, seed):
    """Every leaf that holds one value everywhere (biases, norm scales)
    plus 0.1 * N(0, 1), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if x.size and np.all(x == x.reshape(-1)[0]):
            x = (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


def carried_model(jrun, seed=0):
    """(JAX params, port params) for the smoke run ``jrun``: the JAX
    package's random weights with perturbed constants, carried over."""
    jparams = jbb.init_params(jrun.model, jax.random.PRNGKey(seed),
                              jnp.float32)
    np_params = perturb_constants(jparams, seed + 100)
    jparams = jax.tree.map(jnp.asarray, np_params)
    cfg = base.ModelConfig(**{f.name: getattr(jrun.model, f.name)
                              for f in dataclasses.fields(base.ModelConfig)})
    return jparams, RunConfig(model=cfg), from_jax_params(
        cfg, np_params, device="cpu")


def jax_layers(jparams, plan):
    """The JAX tree's layers in execution order: prefix, groups, suffix."""
    out = list(jparams["prefix"])
    for g in range(plan.n_groups):
        for pos in range(len(plan.pattern)):
            out.append(jax.tree.map(lambda x: x[g], jparams["groups"][pos]))
    return out + list(jparams["suffix"])


def jax_caches(jcfg, state):
    """The JAX DecodeState's caches as one list in execution order."""
    plan = jbb.layer_plan(jcfg)
    out = list(state.prefix)
    for g in range(plan.n_groups):
        for pos in range(len(plan.pattern)):
            out.append(jax.tree.map(lambda x: x[g], state.groups[pos]))
    return out + list(state.suffix)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _jax_run(case):
    arch = case.split("+")[0]
    jrun = jbase.load_smoke_config(arch)
    if case.endswith("+bias"):
        jrun = dataclasses.replace(
            jrun, model=dataclasses.replace(jrun.model, use_bias=True))
    return jrun


@pytest.fixture(scope="module", params=CASES)
def model(request):
    jrun = _jax_run(request.param)
    jparams, run, params = carried_model(jrun)
    return jrun, jparams, run, params


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("loader", ["load_config", "load_smoke_config"])
def test_config_copy_matches_jax(arch, loader):
    """Every field the port keeps has the JAX config's value."""
    got = getattr(base, loader)(arch).model
    want = getattr(jbase, loader)(arch).model
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), \
            field.name


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_param_count_and_plan(arch):
    cfg = base.load_config(arch).model
    assert backbone.count_params(cfg) == FULL_PARAMS[arch] == \
        jbb.count_params(jbase.load_config(arch).model)
    assert backbone.layer_plan(cfg).kinds == ("attn",) * cfg.num_layers
    assert ("head" in backbone.model_specs(cfg)) == \
        (not cfg.tie_embeddings)


def test_unported_archs_and_kinds_are_refused():
    for arch in ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                 "llama-3.2-vision-90b"):
        with pytest.raises(ValueError, match=arch.replace(".", r"\.")):
            base.load_config(arch)
    cfg = base.load_smoke_config("qwen3-4b").model
    for family in ("moe", "vlm"):
        with pytest.raises(ValueError, match="next slice"):
            backbone.layer_plan(dataclasses.replace(cfg, family=family))
    hybrid = dataclasses.replace(cfg, family="hybrid",
                                 block_pattern=("attn", "moe"))
    with pytest.raises(ValueError, match="next slice"):
        backbone.layer_plan(hybrid)


def test_carry_over_copies_every_leaf_in_its_jax_shape(model):
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
    for name in ("final_norm", "head"):
        assert (name in params) == (name in jparams)
        if name in jparams:
            np.testing.assert_array_equal(_np(params[name]),
                                          np.asarray(jparams[name]))
    np.testing.assert_array_equal(_np(params["embed"]["tok"]),
                                  np.asarray(jparams["embed"]["tok"]))


def test_self_attention_matches_jax(model):
    jrun, jparams, run, params = model
    jcfg, cfg = jrun.model, run.model
    x = np.random.default_rng(2).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32)
    jp = jax_layers(jparams, jbb.layer_plan(jcfg))[1]["attn"]
    want, (wk, wv) = jattn.self_attention(
        jp, jnp.asarray(x), jnp.arange(40), num_heads=jcfg.num_heads,
        num_kv_heads=jcfg.num_kv_heads, head_dim=jcfg.head_dim,
        rope_theta=jcfg.rope_theta, qk_norm=jcfg.qk_norm,
        norm_eps=jcfg.norm_eps, q_chunk=jcfg.q_chunk,
        kv_chunk=jcfg.kv_chunk, return_kv=True)
    got, (k, v) = attention.self_attention(
        params["layers"][1]["attn"], torch.tensor(x), torch.arange(40),
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps, return_kv=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ATTN_TOL)
    np.testing.assert_allclose(_np(k), np.asarray(wk), **ATTN_TOL)
    np.testing.assert_allclose(_np(v), np.asarray(wv), **ATTN_TOL)


def _assert_caches_close(caches, jcaches):
    assert len(caches) == len(jcaches)
    for c, jc in zip(caches, jcaches):
        assert type(c).__name__ == type(jc).__name__
        for name, a, b in zip(c._fields, c, jc):
            np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name,
                                       **LOGITS_TOL)


def test_prefill_matches_jax_and_runs_one_attention_per_layer(model,
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
    logits, state = backbone.prefill(params, run.model,
                                     torch.tensor(tokens), max_len=48,
                                     compute_dtype=torch.float32,
                                     cache_dtype=torch.float32)
    assert len(calls) == run.model.num_layers
    assert all(kw["causal"] and kw["window"] == 0 for kw in calls)
    np.testing.assert_allclose(_np(logits), np.asarray(wlogits),
                               **LOGITS_TOL)
    assert state.pos == int(wstate.pos) == 40
    _assert_caches_close(state.layers, jax_caches(jrun.model, wstate))


def test_decode_steps_match_jax(model):
    """Prompt 30, then 8 steps into a full-length cache of 38."""
    jrun, jparams, run, params = model
    tokens = _tokens(run.model, 2, 38, 4)
    wlogits, wstate = jbb.prefill(jparams, jrun.model,
                                  {"tokens": jnp.asarray(tokens[:, :30])},
                                  max_len=38, compute_dtype=jnp.float32,
                                  cache_dtype=jnp.float32)
    logits, state = backbone.prefill(params, run.model,
                                     torch.tensor(tokens[:, :30]),
                                     max_len=38, compute_dtype=torch.float32,
                                     cache_dtype=torch.float32)
    assert state.layers[0].k.shape[1] == 38
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
