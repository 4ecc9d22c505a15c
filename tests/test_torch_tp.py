"""repro_torch's tensor parallelism over the mesh's ``"model"`` axis, on
gloo CPU ranks (one process a mesh device, ``distributed.spawn.
run_ranks``), each rank on one intra-op thread.  Two spawns run every
case: a (1, 2) ``("data", "model")`` mesh and a (2, 2) one.

* The collectives of ``distributed/collectives.py`` (all-reduce,
  all-gather and reduce-scatter over a dim, Megatron's f and g with their
  backward, the partial-softmax combine) against their single-process
  equivalents, on the 2 model ranks of the (1, 2) mesh and on a (1, 4)
  mesh over the 4 ranks of the second spawn: the gathers place values
  (bitwise), the sums round (float32, 1e-6).
* The train step from one JAX-initialised state, float32, three steps,
  SmolLM (its 3 heads stay whole on 2 ranks: ``ff`` and the vocab
  split), Qwen3 (heads, KV heads, ``ff``, vocab and its ``head_dim``
  norms split), RecurrentGemma (the RG-LRU's channels, the windowed
  attention's heads against one whole KV head), Qwen2-MoE (each rank its
  half of the 8 experts and of the shared expert's ``ff``; again with 5
  experts, which do not divide over 2 ranks, so each rank holds its half
  of every expert's ``ff`` columns), all AdamW, and Kimi-K2 (Adafactor
  with a bfloat16 accumulator, as its train config; a dense first layer,
  then MoE layers of 8 experts): against the single-process JAX trainer
  at ``test_three_steps_track_jax``'s bounds (loss 1e-4, grad norm 1e-3,
  parameters within 1e-3 of their move; Kimi-K2's grad norm and
  parameters at that test's bfloat16-accumulator bounds,
  ``bf16_acc_bounds``; RecurrentGemma's grad norm at the hybrid gradient
  bound 3e-2 and its parameters to one process only, where its one
  process stands against JAX too) and against the port's own
  single-process step
  at ``test_torch_train_mesh``'s bounds (loss 1e-5, grad norm 1e-3,
  parameters 1e-4 of their move), each step alone from one process's
  state before it, as that module's 2 x 2 mesh is (its docstring: the
  split products round differently, and chained AdamW steps carry the
  rounding).
* The first step's gradients (float32, before any accumulator's cast),
  leaf by leaf, against one process's: within 2^-18 of each leaf's
  largest entry (float32 rounding of the split sums, measured up to
  2.0e-6), RecurrentGemma's within 2^-12 (measured 1.2e-4) (the RG-LRU's
  ``sqrt(1 - a^2)`` amplifies a gate's rounding; ``test_torch_grad``'s
  hybrid note), the MoE models' within 2^-16 (Qwen2-MoE, measured
  7.8e-6), 2^-14 (5 experts, 2.5e-5) and 2^-13 (Kimi-K2, 7.3e-5).  The
  split's gaps are spread over every leaf upstream of the MoE (the
  embedding, attention and norms part most), and follow how strongly
  each model's gradient answers a change of its input at the size of
  float32 rounding: scaling every embedding row by 1 + 2^-22 moves one
  process's gradients by 1.1e-6 (Qwen3), 9.3e-6 (SmolLM), 2.3e-5
  (Qwen2-MoE), 2.8e-5 (5 experts), 8.1e-5 (Kimi-K2) and 8.6e-5
  (RecurrentGemma) of a leaf's largest entry (``tests/
  torch_tp_grad_gaps.py`` prints both readings).  The router's aux and z
  gradient summed over the 2 ranks, a fault, parts by 0.5 to 0.7.
* Prefill and 4 greedy decode steps under (1, 2), every family that
  decodes, against one process within 1e-5 (float32): the caches split
  by ``kv_seq``, RecurrentGemma's window ring wrapping, the MoE models'
  experts split over the ranks.
* The partial-softmax decode over a ring that wraps against attention
  over the whole cache (1e-5: the merge sums in another order); vocab-parallel ``chunked_xent`` and
  ``_embed`` against the plain ones (the lookup bitwise, the loss and
  gradients 1e-6); ``seq_parallel`` on and off giving the same loss.
* Counts: no ``"model"``-sharded leaf is gathered whole by a train step
  (every gather keeps the rank's model shard, the MoE's experts, router
  columns and shared ``ff`` included), and a decode step's collective
  bytes do not grow with the cache (two cache lengths, the same bytes;
  a MoE layer adds one float32 all-reduce of the step's rows, no expert
  weight).
* The bf16 embedding gradient (ROADMAP queue 3, no longer a fault): the
  port's lookup backward gives the bits ``jax.grad`` gives for the JAX
  package's ``_embed`` over a Zipf batch whose top token repeats over
  1,000 times.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from test_torch_train_mesh import (_each_step_tracks,  # noqa: E402
                                   _ep_step, _init_params, _parted,
                                   _three_steps, check_ep_step, smoke_run)

TIMEOUT_S = 150.0
# name -> (arch, optimizer, model overrides)
TRAIN = {"smollm": ("smollm-360m", "adamw", {}),
         "qwen3": ("qwen3-4b", "adamw", {}),
         "hybrid": ("recurrentgemma-2b", "adamw", {}),
         "moe": ("qwen2-moe-a2.7b", "adamw", {}),
         "moe_ff": ("qwen2-moe-a2.7b", "adamw",
                    {"num_experts": 5, "num_experts_padded": 5}),
         "kimi": ("kimi-k2-1t-a32b", "adafactor", {})}
SERVE = ("smollm-360m", "qwen3-4b", "yi-9b", "recurrentgemma-2b",
         "mamba2-2.7b", "llama-3.2-vision-90b", "command-r-plus-104b",
         "qwen2-moe-a2.7b", "kimi-k2-1t-a32b")
GRAD_BOUND = {"smollm": 2.0 ** -18, "qwen3": 2.0 ** -18,
              "hybrid": 2.0 ** -12, "moe": 2.0 ** -16, "moe_ff": 2.0 ** -14,
              "kimi": 2.0 ** -13}


def train_run(name):
    """The port's smoke run of a ``TRAIN`` case: float32, as
    ``test_torch_train_mesh.smoke_run``; Adafactor without master weights
    (a bfloat16 gradient accumulator, as Kimi-K2's train config)."""
    arch, opt, model = TRAIN[name]
    run = smoke_run(arch, opt, 1, None)
    return dataclasses.replace(
        run, model=dataclasses.replace(run.model, **model),
        train=dataclasses.replace(run.train,
                                  master_weights=opt == "adamw"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data", "model"), device_type="cpu")


# ------------------------------------------------------ the collectives
def _rank_tensor(r, shape, seed=0):
    g = torch.Generator().manual_seed(1000 * seed + r)
    return torch.randn(shape, generator=g)


def _collectives(n):
    """On every rank of a (1, n) mesh: each collective's result and
    gradient beside its single-process equivalent, built from every
    rank's seeded input."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C

    m = _mesh((1, n))
    g = m.get_group(1)
    r = dist.get_rank(g)
    xs = [_rank_tensor(i, (3, 4 * n, 5)) for i in range(n)]
    x = xs[r]
    out = {}
    total = sum(xs)
    out["all_reduce"] = (C.all_reduce_model(x, g), total)
    out["max"] = (C.all_reduce_model(x, g, "max"),
                  torch.stack(xs).amax(0))
    out["all_gather"] = (C.all_gather_model(x, g, 1), torch.cat(xs, 1))
    out["reduce_scatter"] = (C.reduce_scatter_model(x, g, 1),
                             total.chunk(n, 1)[r])
    # Megatron's pair: f's gradient is the sum of the ranks' gradients,
    # g's forward the sum and its gradient as it is
    w = [_rank_tensor(i, (5, 2), seed=1) for i in range(n)]
    xf = xs[0].clone().requires_grad_(True)     # every rank's same input
    y = C.reduce_from_model(C.copy_to_model(xf, g) @ w[r], g)
    (y * y).sum().backward()
    xw = xs[0].clone().requires_grad_(True)
    yw = sum(xw @ wi for wi in w)
    (yw * yw).sum().backward()
    out["f_g"] = (torch.cat([y.detach().flatten(), xf.grad.flatten()]),
                  torch.cat([yw.detach().flatten(), xw.grad.flatten()]))
    # gather (both gradients), scatter, reduce-scatter backward
    xg = x.clone().requires_grad_(True)
    whole = C.gather_model(xg, g, 1, sum_grad=True)
    (whole * torch.arange(whole.numel()).view_as(whole)).sum().backward()
    want = torch.arange(whole.numel(), dtype=torch.float32).view_as(
        whole).chunk(n, 1)[r] * n
    out["gather_sum_grad"] = (xg.grad, want)
    xs2 = x.clone().requires_grad_(True)
    part = C.scatter_model(xs2, g, 1)
    (part * 2).sum().backward()
    # every rank's chunk's gradient, gathered: x is the same on every rank
    mine = torch.full_like(x, 2.0)
    out["scatter"] = (torch.cat([part.detach().flatten(),
                                 xs2.grad.flatten()]),
                      torch.cat([x.chunk(n, 1)[r].flatten(),
                                 mine.flatten()]))
    # the partial-softmax combine against softmax over every rank's keys
    s = [_rank_tensor(i, (2, 3, 7), seed=2) for i in range(n)]
    v = [_rank_tensor(i, (2, 3, 7, 4), seed=3) for i in range(n)]
    o = torch.einsum("bhk,bhkd->bhd", torch.softmax(s[r], -1), v[r])
    got = C.combine_softmax(o, torch.logsumexp(s[r], -1), g)
    p = torch.softmax(torch.cat(s, -1), -1)
    out["combine"] = (got, torch.einsum("bhk,bhkd->bhd", p, torch.cat(v, 2)))
    return {k: (a.detach().numpy(), b.detach().numpy())
            for k, (a, b) in out.items()}


EXACT = ("max", "all_gather", "scatter", "gather_sum_grad")


def _check_collectives(ranks):
    for res in ranks:
        for name, (got, want) in res["collectives"].items():
            if name in EXACT:
                assert np.array_equal(got, want), name
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                           err_msg=name)


# ------------------------------------------------------------ training
def _jax_states():
    import jax

    from repro.configs.base import load_smoke_config as jax_smoke
    from repro.train import trainer as jtrainer
    out = {}
    for name, (arch, _, model) in TRAIN.items():
        run = train_run(name)
        jrun = jax_smoke(arch)
        jrun = dataclasses.replace(jrun, model=dataclasses.replace(
            jrun.model, **model), train=dataclasses.replace(
            jrun.train, **dataclasses.asdict(run.train)))
        out[name] = (jrun, jax.tree.map(
            np.asarray, jtrainer.init_train_state(jrun,
                                                  jax.random.PRNGKey(0))))
    return out


def _first_grads(run, state, mesh=None):
    """One step's gradients (float32, whole, as numpy) of the train loss
    on batch 100, under ``mesh`` when given (read from the parameters'
    ``.grad`` as the step takes them, before any cast)."""
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.launch import shardings
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import trainer
    from test_torch_train_mesh import token_batch

    batch = token_batch(run.model, 100)
    if mesh is None:
        loss, _ = trainer.backbone.train_loss(
            state.params, run.model, batch, compute_dtype=torch.float32)
        loss.backward()
        return [p.grad.numpy() for p in tree_leaves(state.params)]
    with dctx.mesh_context(mesh, sharding.make_rules(fsdp=True)):
        state = shardings.distribute_train_state(state, run, mesh)
        step = trainer.make_train_step(run, total_steps=20)
        grads = {}
        orig = trainer._take_grads

        def spy(leaves, acc_dtype):     # the gradients as the step takes
            grads["g"] = [p.grad.full_tensor().numpy().copy()
                          for p in leaves]
            return orig(leaves, acc_dtype)
        trainer._take_grads = spy
        try:
            step(state, shardings.distribute_batch(batch, run, mesh))
        finally:
            trainer._take_grads = orig
    return grads["g"]


def _train_cases(mesh, states, befores):
    """Every train case's three steps, each step alone from one process's
    state before it (``befores``), the first gradients, and the
    whole-leaf gathers a step made, on this mesh."""
    from repro_torch.distributed import collectives
    from repro_torch.models.convert import from_jax_train_state

    out = {}
    seen = []
    orig = collectives.local_part

    def spy(x, placements):
        names = x.device_mesh.mesh_dim_names
        i = names.index("model")
        if x.placements[i].is_shard() and not placements[i].is_shard():
            seen.append(tuple(x.shape))
        return orig(x, placements)
    collectives.local_part = spy
    try:
        for name in TRAIN:
            run = train_run(name)
            state = from_jax_train_state(run, states[name], device="cpu")
            out[name] = _three_steps(run, state, None, mesh)
            out[name, "each"] = [_three_steps(
                run, from_jax_train_state(run, st, device="cpu"), None, mesh,
                first=i, steps=1) for i, st in enumerate(befores[name])]
            state = from_jax_train_state(run, states[name], device="cpu")
            out[name + "/grads"] = _first_grads(run, state, mesh)
    finally:
        collectives.local_part = orig
    out["model_shards_gathered_whole"] = seen
    return out


# ------------------------------------------------------------- serving
def _serve_params(cfg, seed):
    from repro_torch.models import backbone
    return backbone.init_train_params(
        cfg, torch.Generator().manual_seed(seed), torch.float32, "cpu")


def _place(tree, cfg, mesh, rules):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import context as dctx
    from repro_torch.models import backbone, common
    specs = common.tree_leaves_specs(backbone.train_specs(cfg))
    leaves = [distribute_tensor(x.detach(), mesh, dctx.placements_for(
        mesh, x.shape, s.logical_axes(), rules), src_data_rank=None)
        for x, s in zip(common.tree_leaves(tree), specs)]
    return common.tree_unflatten(tree, leaves)


def _prompt(cfg, S, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, cfg.vocab_size, (2, S)))


def _image(cfg, seed):
    if cfg.family != "vlm":
        return None
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, cfg.num_vision_tokens, cfg.d_model), generator=g)


def _generate(run, params, tokens, image, max_len, steps, mesh=None):
    """Prefill then ``steps`` greedy decode steps: each step's logits and
    the TP collective bytes of each decode step."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.serving import engine

    rules = sharding.make_rules(fsdp=False)
    ctx = dctx.mesh_context(mesh, rules) if mesh is not None else \
        dctx.mesh_context(None)
    logits, moved = [], []
    with ctx, torch.inference_mode():
        if mesh is not None:
            params = _place(params, run.model, mesh, rules)
        else:
            from repro_torch.models import backbone
            params = backbone.serving_params(params, run.model)
        pre = engine.make_serve_step(run, "prefill",
                                     compute_dtype=torch.float32,
                                     max_len=max_len)
        dec = engine.make_serve_step(run, "decode",
                                     compute_dtype=torch.float32)
        lg, state = pre(params, tokens, image_embeds=image)
        logits.append(lg)
        for _ in range(steps):
            tok = torch.argmax(lg[:, :run.model.vocab_size], -1)[:, None]
            collectives.tp_bytes.clear()
            lg, state = dec(params, state, tok)
            moved.append(sum(collectives.tp_bytes.values()))
            logits.append(lg)
    return [x.numpy() for x in logits], moved, state


def _serve_cases():
    from repro_torch.configs import base
    m = _mesh((1, 2))
    out = {}
    for arch in SERVE:
        run = base.load_smoke_config(arch)
        cfg = run.model
        S = 24 if cfg.family != "ssm" else 32
        params = _serve_params(cfg, 7)
        tokens, image = _prompt(cfg, S, 8), _image(cfg, 9)
        got, moved, state = _generate(run, params, tokens, image, S + 4, 4,
                                      m)
        _, moved_long, _ = _generate(run, params, tokens, image, 2 * S + 8,
                                     4, m)
        from repro_torch.models.attention import KVCache
        cache_bytes = max([c.k.numel() * c.k.element_size()
                           for c in state.layers
                           if isinstance(c, KVCache)] or [0])
        want, _, _ = _generate(run, params, tokens, image, S + 4, 4)
        out[arch] = (got, want, moved, moved_long, cache_bytes)
    return out


# ------------------------------------------- attention, vocab, sequence
def _decode_ring():
    """decode_self_attention over a windowed ring that has wrapped: the
    cache split by kv_seq on 2 ranks, against the whole cache."""
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.models import attention

    m = _mesh((1, 2))
    rules = sharding.make_rules(fsdp=False)
    g = torch.Generator().manual_seed(3)
    D, H, Kh, Dh, L, W = 16, 4, 2, 8, 8, 8
    p = {"wq": torch.randn(D, H, Dh, generator=g),
         "wk": torch.randn(D, Kh, Dh, generator=g),
         "wv": torch.randn(D, Kh, Dh, generator=g),
         "wo": torch.randn(H, Dh, D, generator=g)}
    kw = dict(rope_theta=1e4, window=W, num_heads=H, num_kv_heads=Kh)
    k = torch.randn(2, L, Kh, Dh, generator=g)
    v = torch.randn(2, L, Kh, Dh, generator=g)
    x = torch.randn(2, 1, D, generator=g)
    pos = 19                                      # the ring wrapped twice
    want, whole = attention.decode_self_attention(
        p, x, attention.KVCache(k.clone(), v.clone()), pos, **kw)
    from torch.distributed.tensor import distribute_tensor
    with dctx.mesh_context(m, rules), dctx.tp_context(m, rules):
        sl = dctx.local_slice("kv_seq", L)
        local = attention.KVCache(k[:, sl].clone(), v[:, sl].clone())
        pl = {n: distribute_tensor(t, m, dctx.placements_for(
            m, t.shape, s.logical_axes()), src_data_rank=None).to_local()
            for (n, t), s in zip(p.items(), [
                attention.attn_specs(D, H, Kh, Dh)[n] for n in p])}
        got, local = attention.decode_self_attention(pl, x, local, pos,
                                                     cache_len=L, **kw)
    return (got.numpy(), want.numpy(), local.k.numpy(),
            whole.k[:, sl].numpy())


def _vocab_and_sequence():
    """Vocab-parallel ``_embed`` and ``chunked_xent`` against the plain
    ones (values and gradients), and one train loss with the
    ``seq_parallel`` rules against the default ones."""
    from repro_torch.configs import base
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.models import backbone

    m = _mesh((1, 2))
    rules = sharding.make_rules(fsdp=True)
    cfg = base.load_smoke_config("smollm-360m").model
    cfg = dataclasses.replace(cfg, vocab_size=100)     # 28 padded ids
    Vp = backbone.padded_vocab(cfg)
    g = torch.Generator().manual_seed(4)
    tok = torch.randn(Vp, cfg.d_model, generator=g)
    ids = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    x = torch.randn(2, 12, cfg.d_model, generator=g)
    labels = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    valid = torch.rand(2, 12, generator=g) > 0.2

    def run(tp):
        t = tok.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        with dctx.tp_context(m if tp else None, rules):
            sl = dctx.local_slice("vocab", Vp)
            mine = t[sl] if tp else t
            e = backbone._embed({"embed": {"tok": mine}}, cfg, ids,
                                torch.float32)
            ce, met = backbone.chunked_xent({"embed": {"tok": mine}}, cfg,
                                            xx, labels, valid, seq_chunk=4)
        (ce + (e * e).sum() * 1e-3).backward()
        gt = t.grad[sl] if tp else t.grad
        return [e.detach().numpy(), ce.detach().numpy(),
                met["accuracy"].numpy(), xx.grad.numpy(), gt.numpy()], sl

    got, sl = run(True)
    want, _ = run(False)
    want[-1] = want[-1][sl]

    # seq_parallel: the same loss and gradients as without (Qwen3's
    # vocab-split embedding reduce-scatters the rows; HuBERT's frames
    # are scattered by ``shard``)
    from repro_torch.launch import shardings
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.train import trainer
    losses = {}
    for arch in ("qwen3-4b", "hubert-xlarge"):
        run_cfg = smoke_run(arch, "adamw", 1, None)
        for sp in (False, True):
            r = sharding.make_rules(fsdp=True, seq_parallel=sp)
            params = backbone.init_train_params(
                run_cfg.model, torch.Generator().manual_seed(5),
                torch.float32, "cpu")
            with dctx.mesh_context(m, r):
                st = trainer.TrainState(
                    torch.zeros((), dtype=torch.int32), params, None,
                    trainer.optim.adamw_init(params), None)
                dst = shardings.distribute_train_state(st, run_cfg, m)
                batch = shardings.distribute_batch(synthetic_batch(
                    run_cfg.model, np.random.default_rng(3), 4, 16),
                    run_cfg, m)
                _, met = trainer.make_train_step(run_cfg)(dst, batch)
                losses.setdefault(arch, []).append(
                    (float(met["loss"]), float(met["grad_norm"])))
    return got, want, losses


def _spawn_small(mesh, states, befores):
    out = {"collectives": _collectives(2)}
    out["ring"] = _decode_ring()
    out["vocab"] = _vocab_and_sequence()
    out["serve"] = _serve_cases()
    out["train"] = _train_cases(_mesh((1, 2)), states, befores)
    return out


def _spawn_large(mesh, states, befores):
    out = {"collectives": _collectives(4)}
    out["train"] = _train_cases(_mesh((2, 2)), states, befores)
    out["ep_step"] = _ep_step((2, 2))
    return out


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def states():
    return _jax_states()


@pytest.fixture(scope="module")
def spawns(states, single):
    np_states = {k: v[1] for k, v in states.items()}
    befores = {name: single[name][2] for name in TRAIN}
    small = run_ranks(_spawn_small, 2, np_states, befores, device="cpu",
                      timeout_s=TIMEOUT_S)
    large = run_ranks(_spawn_large, 4, np_states, befores, device="cpu",
                      timeout_s=TIMEOUT_S)
    return {"1x2": small, "2x2": large}


@pytest.fixture(scope="module")
def single(states):
    from repro_torch.models.convert import from_jax_train_state
    out = {}
    for name in TRAIN:
        run = train_run(name)
        state = from_jax_train_state(run, states[name][1], device="cpu")
        before = []
        out[name] = _three_steps(run, state, None, before=before) + (
            before,)
        state = from_jax_train_state(run, states[name][1], device="cpu")
        out[name + "/grads"] = _first_grads(run, state)
    return out


@pytest.fixture(scope="module")
def jax_runs(states):
    import jax
    import jax.numpy as jnp

    from repro.train import trainer as jtrainer
    from test_torch_train_mesh import token_batch
    out = {}
    for name in TRAIN:
        jrun, jstate = states[name]
        jstate = jax.tree.map(jnp.asarray, jstate)
        jstep = jax.jit(jtrainer.make_train_step(jrun, total_steps=20))
        metrics = []
        for i in range(3):
            b = {k: jnp.asarray(v.numpy()) for k, v in
                 token_batch(jrun.model, 100 + i).items()}
            jstate, m = jstep(jstate, b, jax.random.PRNGKey(i), None)
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = (metrics, [np.asarray(x) for x in
                               jax.tree.leaves(jstate.params)])
    return out


# --------------------------------------------------------------- tests
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_collectives_match_one_process(mesh, spawns):
    _check_collectives(spawns[mesh])


@pytest.mark.parametrize("case", list(TRAIN))
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_tp_steps_track_jax(mesh, case, spawns, jax_runs, states):
    """Three TP steps against the single-process JAX trainer at
    ``test_three_steps_track_jax``'s bounds.  RecurrentGemma's grad norms
    are held at the hybrid family's gradient bound (3e-2,
    ``test_torch_grad``) and its parameters to one process only (the next
    test): the port's one process parts from JAX by 2.2 % in the third
    step's grad norm and 5.2e-2 of the move in the parameters, the RG-LRU's
    ``sqrt(1 - a^2)`` carrying one ulp of ``exp`` (ROADMAP notes).
    Kimi-K2's bfloat16 accumulator is held at ``bf16_acc_bounds(1)``, as
    ``test_three_steps_track_jax`` holds it in one process."""
    from test_torch_train import bf16_acc_bounds
    (got_m, got_p), (want_m, want_p) = \
        spawns[mesh][0]["train"][case], jax_runs[case]
    gn, pn = {"hybrid": (3e-2, None),
              "kimi": bf16_acc_bounds(1)}.get(case, (1e-3, 1e-3))
    for g, w in zip(got_m, want_m):
        for k, rtol in (("loss", 1e-4), ("grad_norm", gn), ("lr", 1e-6)):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-9,
                                       err_msg=k)
    if pn is not None:
        parted = _parted(got_p, want_p, _init_params(states, case))
        assert 0 < parted <= pn, parted


@pytest.mark.parametrize("case", list(TRAIN))
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_tp_steps_track_one_process(mesh, case, spawns, single):
    """The TP steps against the port's single-process steps at
    ``test_torch_train_mesh``'s bounds, each step alone from one process's
    state before it (that module's docstring); every rank ends each step
    with the same parameters.  Kimi-K2's bfloat16 accumulator rounds each
    side's float32 gradient, which differ by float32 rounding: an entry
    near a rounding boundary lands one bfloat16 ulp (at most 2^-7 of it)
    away, so its grad norm and update are held at
    ``bf16_acc_bounds(1)`` (one rounding of g and of Adafactor's
    statistics), as against JAX (measured: 3.0e-4 of the update)."""
    from test_torch_train import bf16_acc_bounds
    ranks = spawns[mesh]
    each = ranks[0]["train"][case, "each"]
    _each_step_tracks(each, single[case],
                      *(bf16_acc_bounds(1) if case == "kimi" else ()))
    for r in ranks[1:]:
        for (_, got), (_, mine) in zip(r["train"][case, "each"], each):
            for a, b in zip(got, mine):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("case", list(TRAIN))
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_tp_gradients_match_one_process(mesh, case, spawns, single):
    """The first step's gradients leaf by leaf against one process's,
    within ``GRAD_BOUND`` of each leaf's largest entry."""
    got, want = spawns[mesh][0]["train"][case + "/grads"], \
        single[case + "/grads"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        gap = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert gap <= GRAD_BOUND[case], (i, w.shape, gap)


def test_ep_a2a_on_a_data_split_batch(spawns):
    """``moe_impl="ep_a2a"`` in a train step on the (2, 2) mesh, whose
    data ranks split the batch: ``moe_ep`` over ``"model"`` on each
    rank's rows, the losses' mean summing its gradient over ``"data"``,
    against ``moe_ep`` called with the mesh on the whole batch
    (``test_torch_train_mesh.check_ep_step``)."""
    for r in spawns["2x2"]:
        check_ep_step(r["ep_step"])


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_no_model_shard_is_gathered_whole(mesh, spawns):
    """A train step gathers its parameters over the data axes only: every
    gather keeps a leaf's ``"model"`` shard, the MoE blocks' too (their
    experts or experts' ``ff`` columns, router columns and shared
    ``ff``: the router is gathered inside the block, by the model
    group's collective)."""
    for r in spawns[mesh]:
        assert r["train"]["model_shards_gathered_whole"] == []


@pytest.mark.parametrize("arch", SERVE)
def test_prefill_and_decode_match_one_process(arch, spawns):
    for r in spawns["1x2"]:
        got, want, moved, moved_long, cache = r["serve"][arch]
        assert len(got) == len(want) == 5
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("arch", SERVE)
def test_decode_moves_no_cache(arch, spawns):
    """A decode step's collective bytes are the same for a cache twice as
    long: what moves is the new token's K/V, the heads' queries, outputs
    and statistics, never a slot."""
    for r in spawns["1x2"]:
        got, want, moved, moved_long, cache = r["serve"][arch]
        assert moved == moved_long
        assert all(b > 0 for b in moved)


def test_partial_softmax_decode_over_a_wrapped_ring(spawns):
    for r in spawns["1x2"]:
        got, want, k_got, k_want = r["ring"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert np.array_equal(k_got, k_want)     # the owner wrote the slot


def test_vocab_parallel_embed_and_xent(spawns):
    for r in spawns["1x2"]:
        got, want, _ = r["vocab"]
        assert np.array_equal(got[0], want[0])   # the lookup
        for name, g, w in zip(("loss", "accuracy", "dx", "dtok"), got[1:],
                              want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("arch", ["qwen3-4b", "hubert-xlarge"])
def test_seq_parallel_gives_the_same_loss(arch, spawns):
    """The loss with the residual stream split by rows (the
    reduce-scatters sum what the all-reduces sum) and the grad norm."""
    for r in spawns["1x2"]:
        (l0, n0), (l1, n1) = r["vocab"][2][arch]
        assert l0 == l1
        np.testing.assert_allclose(n1, n0, rtol=1e-6)


def test_bf16_embedding_gradient_is_jax_bits():
    """The bf16 lookup's gradient over a Zipf batch (the top token 1,000+
    times): the port's ``backbone._embed`` backward gives the bits of
    ``jax.grad`` of the JAX package's ``_embed``, so summing it in
    float32 would part from the reference (ROADMAP, queue 3 notes)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import load_smoke_config as jax_smoke
    from repro.models import backbone as jbb
    from repro_torch.models import backbone

    jcfg = dataclasses.replace(jax_smoke("smollm-360m").model,
                               vocab_size=64, d_model=32)
    rng = np.random.default_rng(11)
    ids = np.minimum(rng.zipf(1.3, (1, 4096)) - 1, 63).astype(np.int32)
    assert np.bincount(ids.ravel()).max() > 1000
    table = rng.standard_normal((64, 32)).astype(np.float32)
    cot = rng.standard_normal((1, 4096, 32)).astype(np.float32)
    tb = jnp.asarray(table, jnp.bfloat16)
    ct = jnp.asarray(cot, jnp.bfloat16)
    jg = jax.grad(lambda t: jnp.sum(jbb._embed(
        {"embed": {"tok": t}}, jcfg, {"tokens": jnp.asarray(ids)},
        jnp.bfloat16).astype(jnp.float32) * ct.astype(jnp.float32)))(tb)

    t = torch.tensor(table).bfloat16().requires_grad_(True)
    x = backbone._embed({"embed": {"tok": t}}, jcfg,
                        torch.tensor(ids).long(), torch.bfloat16)
    (x.float() * torch.tensor(cot).bfloat16().float()).sum().backward()
    got = t.grad.float().numpy()
    want = np.asarray(jg.astype(jnp.float32))
    assert np.array_equal(got, want)
