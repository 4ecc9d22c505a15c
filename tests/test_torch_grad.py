"""Gradients of repro_torch's training path against the JAX package.

The plain backward versions (``ref.attention_bwd_ref``,
``ref.decay_scan_bwd_ref``) against torch autograd and ``jax.grad`` of
the reference's own functions, and ``backbone.train_loss`` with every
gradient leaf against ``jax.value_and_grad(backbone.train_loss)``, one
smoke config of each family, float32 on the CPU, the JAX weights carried
over in their own layout by ``from_jax_train_params``.  Tolerances, with
their reasons:

* The plain backwards: 1e-5 normwise (max |got - want| over max |want|):
  float32 sums in another order, nothing amplifies them.
* One layer of each kind (``apply_block``), value and every gradient:
  1e-5 normwise.
* ``train_loss`` over the whole smoke model: the loss within 1e-5
  relative; each gradient leaf normwise within its family's bound.  The
  dense, audio and SSM families: 1e-4 (sums in another order through a
  few layers).  The MoE and vision families: 1e-3, since their attention
  gradients are scaled down by the router's gates and the tanh gates
  (the largest is ~1e-3 of the others) and the same absolute rounding is
  a larger share of them.  The hybrid family: 3e-2.  The RG-LRU input
  ``sqrt(1 - a^2)`` cancels where the decay a is near 1, so the one-ulp
  differences of torch's and XLA's ``exp`` grow through the layers:
  computing a with a correctly rounded exp instead of torch's moves the
  port's own gradients by 7e-3 normwise on this model (the serving
  tests hold its states normwise for the same reason), while each block
  alone agrees to 1e-5.
* remat: the same gradients as without it, bitwise (the same ops, run
  again).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs.base import load_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn                   # noqa: E402
from repro.models import backbone as jbb                      # noqa: E402
from repro_torch.configs import base                          # noqa: E402
from repro_torch.kernels import ref                           # noqa: E402
from repro_torch.models import backbone                       # noqa: E402
from repro_torch.models.common import tree_leaves             # noqa: E402
from repro_torch.models.convert import from_jax_train_params  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's many small ops: under the
    suite's parallel workers torch's thread pool costs more than it
    gives.  The count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# one smoke config of each family, with its gradient bound (normwise)
FAMILIES = {"recurrentgemma-2b": 3e-2,      # hybrid
            "smollm-360m": 1e-4,            # dense, tied head
            "mamba2-2.7b": 1e-4,            # SSM
            "hubert-xlarge": 1e-4,          # audio frames, encoder
            "qwen2-moe-a2.7b": 1e-3,        # MoE, aux and z terms
            "llama-3.2-vision-90b": 1e-3}   # vision, image_embeds
# one layer of each kind: (arch, kind)
KINDS = [("recurrentgemma-2b", "rec"), ("recurrentgemma-2b", "attn"),
         ("mamba2-2.7b", "ssd"), ("qwen2-moe-a2.7b", "moe"),
         ("llama-3.2-vision-90b", "cross"), ("hubert-xlarge", "attn")]
B, S = 2, 32


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def perturb_constants(tree, seed):
    """Every leaf that holds one value everywhere (biases, norm scales,
    the tanh gates) plus 0.1 * N(0, 1), drawn with numpy from ``seed``, so
    their gradients are not those of a special point."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if x.size and np.all(x == x.reshape(-1)[0]):
            x = (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


def port_config(jcfg):
    return base.ModelConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(base.ModelConfig)})


def make_batch(cfg, seed, batch=B, seq=S):
    """Numpy inputs for both packages: tokens, or frames and labels (some
    unlabeled), and image_embeds for the vision family."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "frames":
        out["frames"] = rng.normal(size=(batch, seq, cfg.frame_dim)
                                   ).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, (batch, seq))
        labels[:, ::5] = -1
        out["labels"] = labels.astype(np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, seq)
                                     ).astype(np.int32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(batch, cfg.num_vision_tokens, cfg.d_model)
        ).astype(np.float32)
    return out


def torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


LOSS_KW = dict(moe_aux_weight=0.01, moe_z_weight=1e-3)


@pytest.fixture(scope="module", params=list(FAMILIES))
def carried(request):
    """(arch, port config, numpy params, batch, JAX loss, metrics and
    gradient leaves) of a family's smoke model; JAX without remat (its
    remat changes no value)."""
    arch = request.param
    jrun = jax_smoke(arch)
    jcfg = jrun.model
    jparams = jbb.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_params = perturb_constants(jax.tree.map(np.asarray, jparams), 7)
    cfg = port_config(jcfg)
    batch = make_batch(cfg, seed=11)

    def jloss(p):
        return jbb.train_loss(p, jcfg, jax.tree.map(jnp.asarray, batch),
                              compute_dtype=jnp.float32, remat=False,
                              **LOSS_KW)
    (jl, jmet), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, np_params))
    return arch, cfg, np_params, batch, jl, jmet, jax.tree.leaves(jgrads)


# ------------------------------------------------------- plain backwards
ATTN_CASES = [(2, 4, 4, 24, 24, 16, True, 0, 0.0),     # MHA
              (2, 6, 2, 30, 30, 8, True, 0, 0.0),      # GQA
              (1, 4, 1, 40, 40, 16, True, 9, 0.0),     # MQA, window
              (1, 4, 2, 33, 33, 12, True, 0, 5.0),     # softcap, ragged
              (2, 4, 2, 21, 35, 16, False, 0, 0.0)]    # non-causal, ragged


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_bwd_ref_matches_autograd_and_jax(case):
    B_, H, Kh, Sq, Skv, D, causal, window, cap = case
    rng = np.random.default_rng(Sq * D + H)
    qn = rng.normal(size=(B_, H, Sq, D)).astype(np.float32)
    kn, vn = (rng.normal(size=(B_, Kh, Skv, D)).astype(np.float32)
              for _ in range(2))
    don = rng.normal(size=(B_, H, Sq, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=cap)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (qn, kn, vn))
    o, lse = ref.attention_ref(q.detach(), k.detach(), v.detach(),
                               return_lse=True, **kw)
    got = ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(), o, lse,
                                torch.tensor(don), **kw)
    auto = torch.autograd.grad(ref.attention_ref(q, k, v, **kw), (q, k, v),
                               torch.tensor(don))

    def jfn(q, k, v):   # the reference trains through chunked_attention
        out = jattn.chunked_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), jnp.arange(Sq), jnp.arange(Skv),
            causal=causal, window=window, softcap=cap, q_chunk=8,
            kv_chunk=8)
        return jnp.sum(out.transpose(0, 2, 1, 3) * don)
    want = jax.jit(jax.grad(jfn, argnums=(0, 1, 2)))(qn, kn, vn)
    for g, a, w in zip(got, auto, want):
        assert normwise(_np(g), _np(a)) <= 1e-5
        assert normwise(_np(g), w) <= 1e-5


@pytest.mark.parametrize("with_h0", [True, False])
def test_decay_scan_bwd_ref_matches_jax_associative_scan(with_h0):
    rng = np.random.default_rng(3)
    T, C = 45, 12
    a = rng.uniform(0.5, 1.0, (T, C)).astype(np.float32)
    u = rng.normal(size=(T, C)).astype(np.float32)
    g = rng.normal(size=(T, C)).astype(np.float32)
    h0 = rng.normal(size=C).astype(np.float32) if with_h0 else None

    def jscan(a, u, h0):
        if h0 is not None:
            u = u.at[0].add(a[0] * h0)

        def comb(x, y):
            return x[0] * y[0], y[0] * x[1] + y[1]
        return jax.lax.associative_scan(comb, (a, u))[1]

    def jloss(a, u, h0):
        return jnp.sum(jscan(a, u, h0) * g)
    argnums = (0, 1, 2) if with_h0 else (0, 1)
    want = jax.jit(jax.grad(jloss, argnums=argnums))(a, u, h0)
    h = ref.decay_scan_ref(torch.tensor(a), torch.tensor(u),
                           None if h0 is None else torch.tensor(h0))
    got = ref.decay_scan_bwd_ref(torch.tensor(a), h, torch.tensor(g),
                                 None if h0 is None else torch.tensor(h0))
    assert (got[2] is None) == (not with_h0)
    for x, w in zip(got, want):
        assert normwise(_np(x), w) <= 1e-5


# ------------------------------------------------------------ train_loss
@pytest.mark.parametrize("arch,kind", KINDS)
def test_block_gradients_match_jax(arch, kind):
    """One layer (``apply_block``) with a random cotangent: the value, the
    input's and every parameter's gradient against ``jax.vjp``."""
    from repro.models import common as jcommon
    from repro_torch.models import common

    jcfg = jax_smoke(arch).model
    cfg = port_config(jcfg)
    p = jcommon.init_tree(jbb.block_specs(kind, jcfg), jax.random.PRNGKey(3),
                          jnp.float32)
    p = perturb_constants(jax.tree.map(np.asarray, p), 5)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    vis = rng.normal(size=(B, jcfg.num_vision_tokens, jcfg.d_model)).astype(
        np.float32) if kind == "cross" else None

    def jf(p, x):
        y, _, _ = jbb.apply_block(kind, p, x, jcfg, jnp.arange(S), vis)
        return jnp.sum(y * ct)
    jv, (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = common.trainable(common.tree_map(torch.tensor, p))
    tx = torch.tensor(x, requires_grad=True)
    y, _, _ = backbone.apply_block(kind, tp, tx, cfg, torch.arange(S),
                                   None if vis is None else
                                   torch.tensor(vis))
    v = (y * torch.tensor(ct)).sum()
    v.backward()
    v = v.detach()
    assert abs(float(v) - float(jv)) <= 1e-5 * max(abs(float(jv)), 1.0)
    assert normwise(_np(tx.grad), jgx) <= 1e-5
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jgp)):
        assert normwise(_np(g.grad), w) <= 1e-5


@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_and_gradients_match_jax(carried, remat):
    arch, cfg, np_params, batch, jl, jmet, want = carried
    params = from_jax_train_params(cfg, np_params, device="cpu")
    loss, met = backbone.train_loss(params, cfg, torch_batch(batch),
                                    compute_dtype=torch.float32,
                                    remat=remat, **LOSS_KW)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("ce_loss", "accuracy", "tokens", "moe_aux_loss",
              "moe_z_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if cfg.family == "moe":
        assert float(met["moe_aux_loss"]) > 0
    bound = FAMILIES[arch]
    got = [p.grad for p in tree_leaves(params)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None and g.shape == w.shape
        if np.abs(np.asarray(w)).max() == 0:
            assert float(g.abs().max()) == 0
            continue
        assert normwise(_np(g), w) <= bound, (arch, g.shape)


def test_remat_runs_each_group_forward_twice():
    """Under remat each group's layers run forward twice (forward, then
    the recompute in the backward), the prefix and suffix once; the
    gradients equal the run without remat's (the same ops, recomputed)."""
    jrun = jax_smoke("recurrentgemma-2b")
    jparams = jbb.init_params(jrun.model, jax.random.PRNGKey(1),
                              jnp.float32)
    cfg = port_config(jrun.model)
    np_params = jax.tree.map(np.asarray, jparams)
    batch = torch_batch(make_batch(cfg, seed=2))
    calls = {"attn": 0, "scan": 0}
    attn, scan = ref.attention_ref, ref.decay_scan_ref

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    grads = {}
    for remat in (False, True):
        params = from_jax_train_params(cfg, np_params, device="cpu")
        calls.update(attn=0, scan=0)
        ref.attention_ref = count("attn", attn)
        ref.decay_scan_ref = count("scan", scan)
        try:
            loss, _ = backbone.train_loss(params, cfg, batch,
                                          compute_dtype=torch.float32,
                                          remat=remat)
            loss.backward()
        finally:
            ref.attention_ref, ref.decay_scan_ref = attn, scan
        grads[remat] = [p.grad for p in tree_leaves(params)]
        plan = backbone.layer_plan(cfg)
        n_rec = plan.pattern.count("rec") * plan.n_groups
        n_attn = plan.pattern.count("attn") * plan.n_groups
        suffix_rec = plan.suffix.count("rec")
        factor = 2 if remat else 1
        assert calls["scan"] == factor * n_rec + suffix_rec
        assert calls["attn"] == factor * n_attn + plan.suffix.count("attn")
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


def test_ep_a2a_training_raises():
    run = base.load_smoke_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(run.model, moe_impl="ep_a2a")
    params = backbone.init_train_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    batch = torch_batch(make_batch(cfg, seed=1, seq=8))
    with pytest.raises(NotImplementedError, match="moe_ep"):
        backbone.train_loss(params, cfg, batch, compute_dtype=torch.float32)
