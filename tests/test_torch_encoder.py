"""repro_torch's audio family (the HuBERT encoder) against the JAX package.

The smoke config of ``hubert-xlarge`` (2 layers, d 64, frames of 24,
non-causal attention without RoPE, the ungated GELU MLP, an untied head)
in float32 on the CPU, with the JAX package's random weights (constant
leaves perturbed, so the frame bias and the norm scales are not trivial)
carried over by ``from_jax_params``.  Tolerances, with their reasons:

* The MLP and attention alone: 1e-4 elementwise (sums in another order;
  both GELUs are the tanh form).
* ``encode`` logits: rtol = atol = 5e-4, as the other families.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.configs import base as jbase                       # noqa: E402
from repro.models import attention as jattn                   # noqa: E402
from repro.models import backbone as jbb                      # noqa: E402
from repro.models import ffn as jffn                          # noqa: E402
from repro.serving import engine as jengine                   # noqa: E402
from repro_torch.configs import base                          # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.models import attention, backbone, common, ffn  # noqa: E402
from repro_torch.serving import engine                        # noqa: E402
from test_torch_dense import _np, carried_model, jax_layers   # noqa: E402

ARCH = "hubert-xlarge"
TOL = dict(rtol=1e-4, atol=1e-4)
LOGITS_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def model():
    jrun = jbase.load_smoke_config(ARCH)
    jparams, run, params = carried_model(jrun)
    return jrun, jparams, run, params


def _frames(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.frame_dim)).astype(np.float32)


@pytest.mark.parametrize("loader", ["load_config", "load_smoke_config"])
def test_config_copy_matches_jax(loader):
    got = getattr(base, loader)(ARCH).model
    want = getattr(jbase, loader)(ARCH).model
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), \
            field.name


def test_full_size_param_count_and_specs():
    cfg = base.load_config(ARCH).model
    assert backbone.count_params(cfg) == 945_154_560 == \
        jbb.count_params(jbase.load_config(ARCH).model)
    specs = backbone.model_specs(cfg)
    assert set(specs["embed"]) == {"frame_proj", "frame_bias"}
    assert specs["head"].shape == (1280, 512)
    assert "w_gate" not in specs["layers"][0]["mlp"]


def test_gelu_mlp_matches_jax(model):
    jrun, jparams, run, params = model
    x = np.random.default_rng(1).normal(
        size=(2, 20, run.model.d_model)).astype(np.float32)
    jp = jax_layers(jparams, jbb.layer_plan(jrun.model))[0]["mlp"]
    want = jffn.mlp(jp, jnp.asarray(x))
    got = ffn.mlp(params["layers"][0]["mlp"], torch.tensor(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert "w_gate" not in params["layers"][0]["mlp"]


def test_encoder_attention_is_non_causal_without_rope(model, monkeypatch):
    """Against JAX's ``use_rope=False, causal=False``; and a permutation of
    the frames permutes the output the same way, which RoPE or a causal
    mask would break."""
    jrun, jparams, run, params = model
    jcfg, cfg = jrun.model, run.model
    x = np.random.default_rng(2).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32)
    jp = jax_layers(jparams, jbb.layer_plan(jcfg))[1]["attn"]
    want = jattn.self_attention(
        jp, jnp.asarray(x), jnp.arange(24), num_heads=jcfg.num_heads,
        num_kv_heads=jcfg.num_kv_heads, head_dim=jcfg.head_dim,
        rope_theta=jcfg.rope_theta, causal=False, use_rope=False)
    calls = []
    flash = ops.flash_attention

    def counted(*a, **kw):
        calls.append(kw)
        return flash(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    monkeypatch.setattr(common, "apply_rope", None)   # must not be called
    p = params["layers"][1]["attn"]
    kw = backbone._attn_kwargs(cfg)
    got = attention.self_attention(p, torch.tensor(x), torch.arange(24),
                                   causal=cfg.causal, **kw)
    assert calls == [dict(causal=False, window=0, softcap=0.0)]
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    perm = np.random.default_rng(3).permutation(24)
    shuffled = attention.self_attention(p, torch.tensor(x[:, perm]),
                                        torch.arange(24), causal=cfg.causal,
                                        **kw)
    np.testing.assert_allclose(_np(shuffled), _np(got)[:, perm], **TOL)


def test_encode_logits_match_jax(model):
    jrun, jparams, run, params = model
    frames = _frames(run.model, 2, 40, 4)
    want = jbb.encode(jparams, jrun.model, {"frames": jnp.asarray(frames)},
                      compute_dtype=jnp.float32)
    step = engine.make_serve_step(run, "prefill",
                                  compute_dtype=torch.float32)
    got = step(params, torch.tensor(frames))
    assert got.shape == (2, 40, backbone.padded_vocab(run.model))
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS_TOL)
    assert bool((got[..., run.model.vocab_size:] == -1e30).all())
    jstep = jengine.make_serve_step(jrun, "prefill",
                                    compute_dtype=jnp.float32)
    np.testing.assert_allclose(
        _np(got), np.asarray(jstep(jparams, {"frames": jnp.asarray(
            frames)})), **LOGITS_TOL)


def test_encoder_has_no_decode_step(model):
    jrun, _, run, _ = model
    with pytest.raises(ValueError, match="encoder-only"):
        engine.make_serve_step(run, "decode")
    with pytest.raises(AssertionError, match="encoder-only"):
        jengine.make_serve_step(jrun, "decode")
