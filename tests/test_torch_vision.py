"""repro_torch's cross-attention and vision family against the JAX package.

``cross_kv`` / ``cross_attention`` on the same inputs and weights as the
JAX functions (with and without qk-norm and biases), and the smoke config
of ``llama-3.2-vision-90b`` (4 ``attn`` + 1 ``cross`` layer, 16 vision
tokens) in float32 on the CPU, with the JAX package's random weights
carried over by ``from_jax_params``.  JAX initialises the tanh gates to
0, which would multiply the cross-attention and its MLP by 0, so every
constant leaf is perturbed (``test_torch_dense.perturb_constants``)
before the carry-over.  Tolerances, with their reasons:

* Cross K/V and attention outputs: 1e-4 elementwise, as self-attention
  (the port's dense softmax and JAX's online one sum in another order).
* Prefill and decode logits and the caches: rtol = atol = 5e-4, as the
  other families.
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
from repro.models import common as jcommon                    # noqa: E402
from repro_torch.configs import base                          # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.models import attention, backbone            # noqa: E402
from repro_torch.serving import engine                        # noqa: E402
from test_torch_dense import (_np, carried_model, jax_caches,  # noqa: E402
                              jax_layers, perturb_constants)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "llama-3.2-vision-90b"
ATTN_TOL = dict(rtol=1e-4, atol=1e-4)
LOGITS_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def model():
    jrun = jbase.load_smoke_config(ARCH)
    jparams, run, params = carried_model(jrun)
    return jrun, jparams, run, params


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _image(cfg, B, seed):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("loader", ["load_config", "load_smoke_config"])
def test_config_copy_matches_jax(loader):
    got = getattr(base, loader)(ARCH).model
    want = getattr(jbase, loader)(ARCH).model
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), \
            field.name


def test_full_size_param_count_and_plan():
    cfg = base.load_config(ARCH).model
    assert backbone.count_params(cfg) == 87_666_794_536 == \
        jbb.count_params(jbase.load_config(ARCH).model)
    assert backbone.active_params(cfg) == backbone.count_params(cfg)
    kinds = backbone.layer_plan(cfg).kinds
    assert kinds.count("cross") == 20 and kinds.count("attn") == 80
    assert kinds[:5] == ("attn",) * 4 + ("cross",)


@pytest.mark.parametrize("qk_norm_bias", [False, True])
def test_cross_kv_and_cross_attention_match_jax(qk_norm_bias):
    D, H, Kh, hd, Sq, Nv = 48, 4, 2, 16, 21, 11
    jp = jcommon.init_tree(
        jattn.attn_specs(d_model=D, num_heads=H, num_kv_heads=Kh,
                         head_dim=hd, use_bias=qk_norm_bias,
                         qk_norm=qk_norm_bias),
        jax.random.PRNGKey(7), jnp.float32)
    np_p = perturb_constants(jp, 8)
    jp = jax.tree.map(jnp.asarray, np_p)
    p = {k: torch.tensor(np.asarray(v)) for k, v in np_p.items()}
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, Sq, D)).astype(np.float32)
    mem = rng.normal(size=(2, Nv, D)).astype(np.float32)
    kw = dict(qk_norm=qk_norm_bias, norm_eps=1e-6)
    wk, wv = jattn.cross_kv(jp, jnp.asarray(mem), **kw)
    k, v = attention.cross_kv(p, torch.tensor(mem), **kw)
    np.testing.assert_allclose(_np(k), np.asarray(wk), **ATTN_TOL)
    np.testing.assert_allclose(_np(v), np.asarray(wv), **ATTN_TOL)
    heads = dict(num_heads=H, num_kv_heads=Kh, head_dim=hd)
    want = jattn.cross_attention(jp, jnp.asarray(x), (wk, wv), **heads,
                                 **kw)
    got = attention.cross_attention(p, torch.tensor(x), (k, v), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ATTN_TOL)
    # one query token, as the decode attends (plain torch, no kernel)
    want1 = jattn.cross_attention(jp, jnp.asarray(x[:, -1:]), (wk, wv),
                                  **heads, q_chunk=1, **kw)
    got1 = attention.decode_cross_attention(p, torch.tensor(x[:, -1:]),
                                            (k, v), **kw)
    np.testing.assert_allclose(_np(got1), np.asarray(want1), **ATTN_TOL)


def test_carry_over_copies_the_scalar_gates(model):
    jrun, jparams, run, params = model
    jl = jax_layers(jparams, jbb.layer_plan(jrun.model))
    cross = params["layers"][4]
    for name in ("gate_attn", "gate_mlp"):
        assert cross[name].shape == ()
        assert float(cross[name]) == float(jl[4][name]) != 0.0
    for layer, jlayer in zip(params["layers"], jl):
        want = {".".join(k.key for k in path): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(jlayer)[0]}
        got = dict(layer.named_parameters())
        assert sorted(got) == sorted(want)
        for name, p in got.items():
            np.testing.assert_array_equal(_np(p), np.asarray(want[name]),
                                          err_msg=name)


def _assert_caches_close(caches, jcaches):
    assert len(caches) == len(jcaches)
    for i, (c, jc) in enumerate(zip(caches, jcaches)):
        assert type(c).__name__ == type(jc).__name__
        for a, b in zip(c, jc):
            np.testing.assert_allclose(_np(a), np.asarray(b),
                                       err_msg=f"layer {i}", **LOGITS_TOL)


def _jax_prefill(jrun, jparams, tokens, image, max_len):
    return jbb.prefill(jparams, jrun.model,
                       {"tokens": jnp.asarray(tokens),
                        "image_embeds": jnp.asarray(image)},
                       max_len=max_len, compute_dtype=jnp.float32,
                       cache_dtype=jnp.float32)


def test_prefill_with_image_embeds_matches_jax(model, monkeypatch):
    jrun, jparams, run, params = model
    cfg = run.model
    tokens, image = _tokens(cfg, 2, 40, 3), _image(cfg, 2, 4)
    wlogits, wstate = _jax_prefill(jrun, jparams, tokens, image, 48)
    calls = []
    flash = ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((k.shape[2], kw["causal"]))
        return flash(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    logits, state = backbone.prefill(params, cfg, torch.tensor(tokens),
                                     max_len=48, compute_dtype=torch.float32,
                                     cache_dtype=torch.float32,
                                     image_embeds=torch.tensor(image))
    # four causal self-attentions over the prompt, one non-causal
    # cross-attention over the vision tokens
    assert calls == [(40, True)] * 4 + [(cfg.num_vision_tokens, False)]
    np.testing.assert_allclose(_np(logits), np.asarray(wlogits),
                               **LOGITS_TOL)
    _assert_caches_close(state.layers, jax_caches(jrun.model, wstate))
    # the image reaches the logits through the (perturbed) gates
    other, _ = backbone.prefill(params, cfg, torch.tensor(tokens),
                                max_len=48, compute_dtype=torch.float32,
                                cache_dtype=torch.float32,
                                image_embeds=torch.tensor(_image(cfg, 2, 5)))
    assert float((other - logits).abs().max()) > 1e-3


def test_decode_steps_match_jax(model):
    jrun, jparams, run, params = model
    cfg = run.model
    tokens, image = _tokens(cfg, 2, 38, 6), _image(cfg, 2, 7)
    _, wstate = _jax_prefill(jrun, jparams, tokens[:, :30], image, 38)
    _, state = backbone.prefill(params, cfg, torch.tensor(tokens[:, :30]),
                                max_len=38, compute_dtype=torch.float32,
                                cache_dtype=torch.float32,
                                image_embeds=torch.tensor(image))
    for t in range(30, 38):
        tok = tokens[:, t:t + 1]
        wlogits, wstate = jbb.decode_step(jparams, jrun.model, wstate,
                                          jnp.asarray(tok),
                                          compute_dtype=jnp.float32)
        logits, state = backbone.decode_step(params, cfg, state,
                                             torch.tensor(tok),
                                             compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(logits), np.asarray(wlogits),
                                   err_msg=f"position {t}", **LOGITS_TOL)
    _assert_caches_close(state.layers, jax_caches(jrun.model, wstate))


def test_serve_steps_take_image_embeds_and_generate_refuses_vlm(model):
    jrun, jparams, run, params = model
    cfg = run.model
    tokens, image = _tokens(cfg, 2, 12, 8), _image(cfg, 2, 9)
    prefill = engine.make_serve_step(run, "prefill",
                                     compute_dtype=torch.float32, max_len=16)
    logits, state = prefill(params, torch.tensor(tokens),
                            torch.tensor(image))
    want, _ = backbone.prefill(params, cfg, torch.tensor(tokens), max_len=16,
                               compute_dtype=torch.float32,
                               cache_dtype=torch.float32,
                               image_embeds=torch.tensor(image))
    assert torch.equal(logits, want)
    with pytest.raises(ValueError, match="image_embeds"):
        prefill(params, torch.tensor(tokens))
    with pytest.raises(ValueError, match="vision family"):
        engine.generate(run, params, torch.tensor(tokens), max_new_tokens=2)
