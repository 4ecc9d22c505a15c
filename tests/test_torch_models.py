"""repro_torch's RecurrentGemma serving path against the JAX package.

The smoke config (5 layers: rec, rec, attn, rec, rec; d 64; window 16) in
float32 on the CPU, with the JAX package's random weights carried over by
``from_jax_params``.  Tolerances, with their reasons:

* Attention alone: 1e-4 elementwise.  The port's dense softmax and JAX's
  online one sum in another order; nothing amplifies the difference.
* Anything downstream of an RG-LRU block: the RG-LRU input
  ``u = sqrt(1 - a^2) * i * x`` cancels where the decay ``a`` is close to
  1, so a one-ulp difference in ``a`` (torch's and XLA's ``exp`` and
  ``sigmoid`` round differently on some inputs) moves ``u`` by far more
  than one ulp, and every state after it.  So block outputs and decode
  states, which grow to tens at this config, are held *normwise*,
  max |got - want| <= 2e-3 * max |want|, and the logits, which are
  O(0.5) after the final norm, elementwise at rtol = atol = 5e-4.  The
  scan itself is held at 1e-5 in ``test_torch_scan_attention.py``.
* Greedy ``generate``: equal tokens.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs.base import load_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn                   # noqa: E402
from repro.models import backbone as jbb                      # noqa: E402
from repro.models import rglru as jrglru                      # noqa: E402
from repro.serving import engine as jengine                   # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, load_config,  # noqa: E402
                                      load_smoke_config)
from repro_torch.kernels import decay_scan as ds              # noqa: E402
from repro_torch.launch import serve                          # noqa: E402
from repro_torch.models import attention, backbone, rglru     # noqa: E402
from repro_torch.models.convert import from_jax_params        # noqa: E402
from repro_torch.serving import engine                        # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "recurrentgemma-2b"
ATTN_TOL = dict(rtol=1e-4, atol=1e-4)
LOGITS_TOL = dict(rtol=5e-4, atol=5e-4)
STATE_TOL = 2e-3        # normwise, see the module docstring
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    jrun = jax_smoke(ARCH)
    jparams = jbb.init_params(jrun.model, jax.random.PRNGKey(0),
                              jnp.float32)
    run = load_smoke_config(ARCH)
    params = from_jax_params(run.model, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jrun, jparams, run, params


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_layer(jparams, plan, idx):
    """Layer ``idx`` (execution order) of the stacked JAX tree."""
    n = len(plan.pattern) * plan.n_groups
    if idx >= n:
        return jparams["suffix"][idx - n]
    g, pos = divmod(idx, len(plan.pattern))
    return jax.tree.map(lambda x: x[g], jparams["groups"][pos])


def _jax_caches(jcfg, state):
    """The JAX DecodeState's caches as one list in execution order."""
    plan = jbb.layer_plan(jcfg)
    out = []
    for g in range(plan.n_groups):
        for pos in range(len(plan.pattern)):
            out.append(jax.tree.map(lambda x: x[g], state.groups[pos]))
    return out + list(state.suffix)


def _assert_normwise(got, want, name=""):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= STATE_TOL * scale, f"{name}: {err} > {STATE_TOL} * {scale}"


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def test_layer_plan_and_param_count():
    from repro.configs.base import load_config as jax_full
    full = load_config(ARCH).model
    assert backbone.count_params(full) == 2_894_574_080 == \
        jbb.count_params(jax_full(ARCH).model)
    smoke = load_smoke_config(ARCH).model
    assert backbone.count_params(smoke) == \
        jbb.count_params(jax_smoke(ARCH).model)
    plan = backbone.layer_plan(full)
    assert plan.kinds.count("rec") == 18 and plan.kinds.count("attn") == 8
    assert plan.suffix == ("rec", "rec")
    with pytest.raises(ValueError, match="not ported"):
        load_config("qwen2-moe-a2.7b")


@pytest.mark.parametrize("loader", ["load_config", "load_smoke_config"])
def test_config_copy_matches_jax(loader):
    """Every field the port keeps has the JAX config's value."""
    import dataclasses

    from repro.configs import base as jbase
    from repro_torch.configs import base
    got = getattr(base, loader)(ARCH).model
    want = getattr(jbase, loader)(ARCH).model
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), \
            field.name


def test_carry_over_copies_every_leaf_in_its_jax_shape(model):
    jrun, jparams, run, params = model
    plan = jbb.layer_plan(jrun.model)
    for idx, layer in enumerate(params["layers"]):
        want = {".".join(k.key for k in path): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(
                    _jax_layer(jparams, plan, idx))[0]}
        got = dict(layer.named_parameters())
        assert sorted(got) == sorted(want)
        for name, p in got.items():
            np.testing.assert_array_equal(_np(p), np.asarray(want[name]),
                                          err_msg=name)
    np.testing.assert_array_equal(_np(params["embed"]["tok"]),
                                  np.asarray(jparams["embed"]["tok"]))


def test_rglru_block_matches_jax(model):
    jrun, jparams, run, params = model
    x = np.random.default_rng(1).normal(size=(2, 40, 64)).astype(np.float32)
    jp = _jax_layer(jparams, jbb.layer_plan(jrun.model), 0)["rglru"]
    want, wstate = jrglru.rglru_block(jp, jnp.asarray(x), jrun.model,
                                      return_state=True)
    launches = ds.launches
    got, state = rglru.rglru_block(params["layers"][0]["rglru"],
                                   torch.tensor(x), run.model,
                                   return_state=True)
    assert ds.launches == launches          # the CPU runs the plain scan
    _assert_normwise(got, want, "out")
    _assert_normwise(state.conv, wstate.conv, "conv")
    _assert_normwise(state.h, wstate.h, "h")


def test_self_attention_matches_jax(model):
    jrun, jparams, run, params = model
    jcfg, cfg = jrun.model, run.model
    x = np.random.default_rng(2).normal(size=(2, 40, 64)).astype(np.float32)
    jp = _jax_layer(jparams, jbb.layer_plan(jcfg), 2)["attn"]
    want, (wk, wv) = jattn.self_attention(
        jp, jnp.asarray(x), jnp.arange(40), num_heads=jcfg.num_heads,
        num_kv_heads=jcfg.num_kv_heads, head_dim=jcfg.head_dim,
        rope_theta=jcfg.rope_theta, window=jcfg.attn_window,
        q_chunk=jcfg.q_chunk, kv_chunk=jcfg.kv_chunk, return_kv=True)
    got, (k, v) = attention.self_attention(
        params["layers"][2]["attn"], torch.tensor(x), torch.arange(40),
        rope_theta=cfg.rope_theta, window=cfg.attn_window, return_kv=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ATTN_TOL)
    np.testing.assert_allclose(_np(k), np.asarray(wk), **ATTN_TOL)
    np.testing.assert_allclose(_np(v), np.asarray(wv), **ATTN_TOL)


def _assert_caches_close(caches, jcaches):
    assert len(caches) == len(jcaches)
    for c, jc in zip(caches, jcaches):
        assert type(c).__name__ == type(jc).__name__
        for name, a, b in zip(c._fields, c, jc):
            _assert_normwise(a, b, name)


def test_prefill_matches_jax(model):
    jrun, jparams, run, params = model
    tokens = _tokens(run.model, 2, 40, 3)
    wlogits, wstate = jbb.prefill(jparams, jrun.model,
                                  {"tokens": jnp.asarray(tokens)},
                                  max_len=48, compute_dtype=jnp.float32,
                                  cache_dtype=jnp.float32)
    logits, state = backbone.prefill(params, run.model,
                                     torch.tensor(tokens), max_len=48,
                                     compute_dtype=torch.float32,
                                     cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(logits), np.asarray(wlogits),
                               **LOGITS_TOL)
    assert state.pos == int(wstate.pos) == 40
    _assert_caches_close(state.layers, _jax_caches(jrun.model, wstate))


def test_decode_steps_across_the_ring_wrap_match_jax(model):
    """Prompt 30, then 8 steps at positions 30..37: the 16-slot ring cache
    wraps from slot 15 to slot 0 at position 32."""
    jrun, jparams, run, params = model
    tokens = _tokens(run.model, 2, 38, 4)
    kw = dict(max_len=38)
    wlogits, wstate = jbb.prefill(jparams, jrun.model,
                                  {"tokens": jnp.asarray(tokens[:, :30])},
                                  compute_dtype=jnp.float32,
                                  cache_dtype=jnp.float32, **kw)
    logits, state = backbone.prefill(params, run.model,
                                     torch.tensor(tokens[:, :30]),
                                     compute_dtype=torch.float32,
                                     cache_dtype=torch.float32, **kw)
    assert state.layers[2].k.shape[1] == 16
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
    _assert_caches_close(state.layers, _jax_caches(jrun.model, wstate))


def test_decode_from_an_empty_state_matches_jax(model):
    """``init_decode_state`` then 6 steps from position 0 (no prefill)."""
    jrun, jparams, run, params = model
    tokens = _tokens(run.model, 2, 6, 7)
    wstate = jbb.init_decode_state(jrun.model, 2, 6, jnp.float32)
    state = backbone.init_decode_state(run.model, 2, 6, torch.float32,
                                       "cpu")
    _assert_caches_close(state.layers, _jax_caches(jrun.model, wstate))
    for t in range(6):
        tok = tokens[:, t:t + 1]
        wlogits, wstate = jbb.decode_step(jparams, jrun.model, wstate,
                                          jnp.asarray(tok),
                                          compute_dtype=jnp.float32)
        logits, state = backbone.decode_step(params, run.model, state,
                                             torch.tensor(tok),
                                             compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(logits), np.asarray(wlogits),
                                   err_msg=f"position {t}", **LOGITS_TOL)
    _assert_caches_close(state.layers, _jax_caches(jrun.model, wstate))


def test_greedy_generate_tokens_equal_jax(model):
    jrun, jparams, run, params = model
    prompt = _tokens(run.model, 2, 24, 5)
    want = jengine.generate(jrun, jparams, jnp.asarray(prompt),
                            max_new_tokens=12)
    got = engine.generate(run, params, torch.tensor(prompt),
                          max_new_tokens=12)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_sampling_draws_from_the_generator(model):
    _, _, run, params = model
    prompt = torch.tensor(_tokens(run.model, 2, 8, 6))
    draw = lambda seed: engine.generate(
        run, params, prompt, max_new_tokens=6, temperature=1.0,
        gen=torch.Generator().manual_seed(seed))
    np.testing.assert_array_equal(_np(draw(1)), _np(draw(1)))
    assert _np(draw(1)).shape == (2, 14)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_cli_smoke_on_cpu(capsys, arch):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--requests", "2", "--batch", "2", "--prompt-len", "32",
                "--new-tokens", "4"])
    out = capsys.readouterr().out
    if load_smoke_config(arch).model.causal:
        assert "batch 0: prefill ok, decoded 4 tokens" in out
        assert "served 2 requests on cpu" in out
    else:                               # the encoder encodes frames
        assert "encoded 2x32 frames -> (2, 32, 128) on cpu" in out


def test_serve_cli_defaults_to_recurrentgemma(monkeypatch):
    seen = []
    monkeypatch.setattr(serve, "_serve_llm", lambda a: seen.append(a.arch))
    serve.main([])
    assert seen == [ARCH]


def test_port_imports_neither_jax_nor_repro():
    """Import every module of ``repro_torch`` and ``chip_smoke.py``'s
    import block in a fresh interpreter: no ``jax`` and no ``repro``
    module may load."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
