"""repro_torch's Mamba-2 (SSD) family against the JAX package.

The smoke config of ``mamba2-2.7b`` (2 layers, d 64, 2 heads of 64, state
16, chunk 8) in float32 on the CPU, with the JAX package's random weights
(constant leaves perturbed) carried over by ``from_jax_params``.  The
inter-chunk recurrence runs through ``ops.decay_scan`` (the plain loop on
the CPU) and is shifted to the reference's exclusive ``h_prior``; S = 32
gives four chunks, so the shift is exercised, and S <= the chunk gives
one.  Tolerances, with their reasons:

* Block outputs, final states and decode outputs: rtol = atol = 1e-4.
  ``exp(segsum)`` and the chunk decays are exponentials of cumulative
  sums, which torch and XLA round differently by an ulp; the exponential
  carries that relative error into the states, summed over a few chunks.
* Logits (O(1) after the final norm): rtol = atol = 5e-4, as the other
  families.
* Greedy ``generate``: equal tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.configs import base as jbase                       # noqa: E402
from repro.models import backbone as jbb                      # noqa: E402
from repro.models import mamba2 as jmamba2                    # noqa: E402
from repro.serving import engine as jengine                   # noqa: E402
from repro_torch.configs import base                          # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.models import backbone, mamba2               # noqa: E402
from repro_torch.serving import engine                        # noqa: E402
from test_torch_dense import (_np, carried_model, jax_caches,  # noqa: E402
                              jax_layers)

ARCH = "mamba2-2.7b"
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
LOGITS_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def model():
    jrun = jbase.load_smoke_config(ARCH)
    jparams, run, params = carried_model(jrun)
    return jrun, jparams, run, params


def _assert_state_close(state, wstate):
    assert type(state).__name__ == type(wstate).__name__ == "SSMState"
    for name, a, b in zip(state._fields, state, wstate):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name,
                                   **SSD_TOL)


@pytest.mark.parametrize("loader", ["load_config", "load_smoke_config"])
def test_config_copy_matches_jax(loader):
    got = getattr(base, loader)(ARCH).model
    want = getattr(jbase, loader)(ARCH).model
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), \
            field.name


def test_full_size_param_count_and_plan():
    cfg = base.load_config(ARCH).model
    assert backbone.count_params(cfg) == 2_831_418_880 == \
        jbb.count_params(jbase.load_config(ARCH).model)
    assert backbone.layer_plan(cfg).kinds == ("ssd",) * 64


@pytest.mark.parametrize("S", [32, 8, 6])
def test_ssd_block_and_final_state_match_jax(model, S, monkeypatch):
    """S = 32: four chunks of 8; S = 8: one whole chunk; S = 6: one chunk
    shorter than ``ssm_chunk``.  One ``decay_scan`` over [nC, B*H*N*P]."""
    jrun, jparams, run, params = model
    cfg = run.model
    x = np.random.default_rng(S).normal(
        size=(2, S, cfg.d_model)).astype(np.float32)
    jp = jax_layers(jparams, jbb.layer_plan(jrun.model))[0]["ssd"]
    want, wstate = jmamba2.ssd_block(jp, jnp.asarray(x), jrun.model,
                                     return_state=True)
    shapes = []
    scan = ops.decay_scan

    def counted(a, u, h0=None):
        shapes.append(tuple(a.shape))
        return scan(a, u, h0)
    monkeypatch.setattr(ops, "decay_scan", counted)
    got, state = mamba2.ssd_block(params["layers"][0]["ssd"],
                                  torch.tensor(x), cfg, return_state=True)
    d_inner = cfg.ssm_expand * cfg.d_model
    nC = S // min(cfg.ssm_chunk, S)
    assert shapes == [(nC, 2 * d_inner * cfg.ssm_state)]
    np.testing.assert_allclose(_np(got), np.asarray(want), **SSD_TOL)
    _assert_state_close(state, wstate)


def test_ssd_block_refuses_a_ragged_last_chunk(model):
    _, _, run, params = model
    x = torch.zeros(1, 12, run.model.d_model)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mamba2.ssd_block(params["layers"][0]["ssd"], x, run.model)


def test_ssd_decode_steps_match_jax(model):
    """Four steps from a prefill state and from the empty state."""
    jrun, jparams, run, params = model
    cfg = run.model
    rng = np.random.default_rng(11)
    jp = jax_layers(jparams, jbb.layer_plan(jrun.model))[1]["ssd"]
    p = params["layers"][1]["ssd"]
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    _, wstate = jmamba2.ssd_block(jp, jnp.asarray(x), jrun.model,
                                  return_state=True)
    _, state = mamba2.ssd_block(p, torch.tensor(x), cfg, return_state=True)
    empty = (jmamba2.ssd_init_state(jrun.model, 2, jnp.float32),
             mamba2.ssd_init_state(cfg, 2, torch.float32, "cpu"))
    for wst, st in ((wstate, state), empty):
        for _ in range(4):
            xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
            want, wst = jmamba2.ssd_decode_step(jp, jnp.asarray(xt), wst,
                                                jrun.model)
            got, st = mamba2.ssd_decode_step(p, torch.tensor(xt), st, cfg)
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       **SSD_TOL)
        _assert_state_close(st, wst)


def test_prefill_and_decode_logits_match_jax(model, monkeypatch):
    """Prompt 32 (four chunks), then 6 decode steps; the prefill launches
    one scan per SSD layer and no attention."""
    jrun, jparams, run, params = model
    tokens = np.random.default_rng(4).integers(0, run.model.vocab_size,
                                               (2, 38))
    wlogits, wstate = jbb.prefill(jparams, jrun.model,
                                  {"tokens": jnp.asarray(tokens[:, :32])},
                                  max_len=38, compute_dtype=jnp.float32,
                                  cache_dtype=jnp.float32)
    calls = {"decay_scan": 0, "flash_attention": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    logits, state = backbone.prefill(params, run.model,
                                     torch.tensor(tokens[:, :32]),
                                     max_len=38, compute_dtype=torch.float32,
                                     cache_dtype=torch.float32)
    assert calls == {"decay_scan": run.model.num_layers,
                     "flash_attention": 0}
    np.testing.assert_allclose(_np(logits), np.asarray(wlogits),
                               **LOGITS_TOL)
    for st, wst in zip(state.layers, jax_caches(jrun.model, wstate)):
        _assert_state_close(st, wst)
    for t in range(32, 38):
        tok = tokens[:, t:t + 1]
        wlogits, wstate = jbb.decode_step(jparams, jrun.model, wstate,
                                          jnp.asarray(tok),
                                          compute_dtype=jnp.float32)
        logits, state = backbone.decode_step(params, run.model, state,
                                             torch.tensor(tok),
                                             compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(logits), np.asarray(wlogits),
                                   err_msg=f"position {t}", **LOGITS_TOL)
    assert calls["decay_scan"] == run.model.num_layers


def test_greedy_generate_tokens_equal_jax(model):
    jrun, jparams, run, params = model
    prompt = np.random.default_rng(5).integers(0, run.model.vocab_size,
                                               (2, 16))
    want = jengine.generate(jrun, jparams, jnp.asarray(prompt),
                            max_new_tokens=8)
    got = engine.generate(run, params, torch.tensor(prompt),
                          max_new_tokens=8)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_bf16_decode_drift_is_the_references():
    """In bfloat16 a Mamba-2 decode drifts from a teacher-forced forward
    over the same tokens (the recurrent form keeps a float32 state, the
    chunked form rounds its products to bfloat16), and the drift grows
    with depth on random weights.  The port's drift must be of the JAX
    reference's own size (within 2x, on the same weights and tokens): the
    port rounds where the reference does.  8 layers of width 128, chunks
    of 16, a 32-token prompt and 16 greedy steps."""
    import jax

    jrun = jbase.load_smoke_config(ARCH)
    jrun = dataclasses.replace(jrun, model=dataclasses.replace(
        jrun.model, d_model=128, num_layers=8, ssm_state=32, ssm_chunk=16,
        vocab_size=512))
    jparams, run, params = carried_model(jrun)
    cfg, V = run.model, run.model.vocab_size
    P, N = 32, 16
    prompt = np.random.default_rng(7).integers(0, V, (2, P))

    def drift(steps, want):
        want = np.asarray(want, np.float64)[..., :V]
        return max(np.linalg.norm(np.asarray(s, np.float64)[:, :V]
                                  - want[:, i]) / np.linalg.norm(want[:, i])
                   for i, s in enumerate(steps))

    bf16 = torch.bfloat16
    with torch.inference_mode():
        logits, st = backbone.prefill(params, cfg, torch.tensor(prompt),
                                      max_len=P + N, compute_dtype=bf16,
                                      cache_dtype=bf16)
        steps, fed = [logits.float()], []
        for _ in range(N):
            fed.append(torch.argmax(logits[:, :V], -1)[:, None])
            logits, st = backbone.decode_step(params, cfg, st, fed[-1],
                                              compute_dtype=bf16)
            steps.append(logits.float())
        seq = torch.cat([torch.tensor(prompt)] + fed, 1)
        hidden = backbone.forward_hidden(params, cfg, seq,
                                         compute_dtype=bf16)
        want = backbone.logits_from_hidden(params, cfg,
                                           hidden[:, P - 1:P + N]).float()
    port = drift([_np(s) for s in steps], _np(want))

    jdt = jnp.bfloat16
    wl, ws = jbb.prefill(jparams, jrun.model, {"tokens": jnp.asarray(prompt)},
                         max_len=P + N, compute_dtype=jdt, cache_dtype=jdt)
    jsteps = [wl]
    for t in fed:
        wl, ws = jbb.decode_step(jparams, jrun.model, ws,
                                 jnp.asarray(_np(t)), compute_dtype=jdt)
        jsteps.append(wl)
    jh, _ = jbb.forward_hidden(jparams, jrun.model,
                               {"tokens": jnp.asarray(_np(seq))},
                               compute_dtype=jdt)
    jwant = jbb.logits_from_hidden(jparams, jrun.model, jh[:, P - 1:P + N])
    ref = drift([np.asarray(s, np.float32) for s in jsteps],
                np.asarray(jax.device_get(jwant), np.float32))
    assert 0.0 < port <= 2.0 * ref, (port, ref)
