"""Print how far the port's training steps part from the JAX trainer's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_train_gaps.py

The measurements behind ``tests/test_torch_train.py``'s bounds and its
two ``xfail`` reasons, on the CPU at the smoke size (about two minutes):

* chained: each case of ``test_three_steps_track_jax``, with each step's
  grad-norm gap and the parameters' distance from JAX over the distance
  they moved;
* each step from JAX's state (``_each_step``): the update's gap and each
  optimizer moment's, for the bf16 accumulator and the HT sync with
  stragglers;
* the witness (``_jax_parted``): JAX against itself with step 1's
  parameters moved by the port's step-1 gap, one reading a seed;
* the HT sync's step 1 on a 2-way accumulation with a straggler mask,
  intermediate by intermediate (``ht_2way_bisect``): the kept
  micro-batch's gradient leaf by leaf, the kept-block masks, the thinned
  gradients from the same gradients, and the clip.

It prints one JSON object.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_train as T                                  # noqa: E402


def ht_2way_bisect() -> dict:
    """Step 1 of the HT sync with the mask (True, False), from JAX's state
    after step 0, intermediate by intermediate: each gradient leaf's gap
    (max |got - want| over max |want|), whether JAX's scanned
    accumulation equals its one-micro-batch gradient, the masks, and the
    sync and clip run on JAX's own gradients."""
    from repro.models import backbone as jb
    from repro.train import compression as jc
    from repro.train import optim as jo
    from repro.train import trainer as jt
    from repro_torch.models import backbone as tb
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.models.convert import from_jax_train_state

    torch = T.torch
    keep = (True, False)
    with pytest.MonkeyPatch.context() as mp:
        run, jrun = T._both_runs("smollm-360m", "adamw", 2, True, "ht", mp)
        jstate = jt.init_train_state(jrun, jax.random.PRNGKey(0))
        jstep = jax.jit(jt.make_train_step(jrun, total_steps=20))
        jstate, _ = jstep(jstate, T.jax_batch(T.token_batch(run.model, 100)),
                          jax.random.PRNGKey(0), jnp.asarray(keep))
        batch = T.token_batch(run.model, 101)
        tr = jrun.train
        kw = dict(remat=True, moe_aux_weight=tr.moe_aux_weight,
                  moe_z_weight=tr.moe_z_weight)
        gfn = jax.grad(lambda p, mb: jb.train_loss(
            p, jrun.model, mb, compute_dtype=jnp.float32, **kw)[0])
        half = {k: v[:2] for k, v in T.jax_batch(batch).items()}
        jg = jax.jit(gfn)(jstate.params, half)
        ccfg = jc.ThinnedSyncConfig(budget=tr.thinned_sync_budget,
                                    alpha=tr.thinned_sync_alpha)
        jsg, _, jm = jax.jit(lambda g, s, k: jc.thin_gradients(
            g, s, k, ccfg))(jg, jstate.sync, jax.random.PRNGKey(1))
        jcg, jn = jax.jit(lambda g: jo.clip_by_global_norm(
            g, tr.grad_clip))(jsg)

        state = from_jax_train_state(run, jax.tree.map(np.asarray, jstate),
                                     device="cpu")
        leaves = tree_leaves(state.params)
        loss, _ = tb.train_loss(state.params, run.model,
                                {k: v[:2] for k, v in batch.items()},
                                compute_dtype=torch.float32, **kw)
        loss.backward()
        tg = [p.grad.clone() for p in leaves]
        tcfg = T.compression.ThinnedSyncConfig(
            budget=tr.thinned_sync_budget, alpha=tr.thinned_sync_alpha)
        jl = [np.asarray(x) for x in jax.tree.leaves(jg)]
        sg_same, _, _ = T.compression.thin_gradients(
            tree_unflatten(state.params, [torch.tensor(x) for x in jl]),
            state.sync, T.prng_key(1), tcfg)
        sg, _, m = T.compression.thin_gradients(
            tree_unflatten(state.params, tg), state.sync, T.prng_key(1),
            tcfg)
        # the clip scales in place: clip a copy
        cg, n = T.optim.clip_by_global_norm(
            T.tree_map(torch.clone, sg_same), tr.grad_clip)

    def gap(a, b):
        return float(np.abs(T._np(a) - b).max()
                     / max(np.abs(b).max(), 1e-30))

    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    jsl = [np.asarray(x) for x in jax.tree.leaves(jsg)]
    return {
        "grad_gap_by_leaf": {nm: gap(a, b) for nm, a, b in
                             zip(names, tg, jl)},
        "masks_equal": all(
            bool(((T._np(a).reshape(-1) != 0) == (b.reshape(-1) != 0)).all())
            for a, b in zip(tree_leaves(sg), jsl)),
        "sync_volume_fraction": (float(m["sync_volume_fraction"]),
                                 float(jm["sync_volume_fraction"])),
        "thinned_gap": max(gap(a, b) for a, b in zip(tree_leaves(sg), jsl)),
        "thinned_gap_same_grads": max(
            gap(a, b) for a, b in zip(tree_leaves(sg_same), jsl)),
        "clip_gap_same_grads": max(
            gap(a, np.asarray(b)) for a, b in
            zip(tree_leaves(cg), jax.tree.leaves(jcg))),
        "grad_norm": (float(n), float(jn))}


def main() -> int:
    T.torch.set_num_threads(1)
    out = {"chained": {}, "each_step": {}, "jax_parted": {}}
    for case in T._three_steps_cases():
        name, (arch, opt, accum, keep, sync, master) = case.id, case.values
        with pytest.MonkeyPatch.context() as mp:
            run, jrun = T._both_runs(arch, opt, accum, master, sync, mp)
            metrics, _, parted = T._chained(run, jrun, keep)
        out["chained"][name] = {
            "grad_norm_gap": [abs(a / b - 1) for a, b in
                              (m["grad_norm"] for m in metrics)],
            "parted": float(parted)}
    for case, (opt, accum, master, sync, keep) in T.GAP_CASES.items():
        with pytest.MonkeyPatch.context() as mp:
            run, jrun = T._both_runs("smollm-360m", opt, accum, master,
                                     sync, mp)
            recs = T._each_step(run, jrun, keep)
            out["each_step"][case] = [
                {"update": r["update"], "moments": r["moments"]}
                for r in recs]
            out["jax_parted"][case] = [float(x) for x in T._jax_parted(
                run, jrun, keep, recs[1]["update"])]
    out["ht_2way_bisect"] = ht_2way_bisect()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
