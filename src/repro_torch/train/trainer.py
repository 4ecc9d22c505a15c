"""Training step builder (PyTorch port of ``repro.train.trainer``): grad
accumulation, remat, mixed precision, optional HT-thinned gradient sync,
straggler-tolerant microbatching.

``make_train_step(run)`` returns ``train_step(state, batch, rng=None,
micro_keep=None) -> (state, metrics)``, the reference's step line for
line: a float32 master copy only when ``param_dtype`` is not float32;
the gradient accumulator in float32 for AdamW or master weights, else
bfloat16; the batch split into ``grad_accum`` microbatches (the scan is a
Python loop, one ``backward`` a microbatch); the straggler mask
``micro_keep`` with its HT weight and the masked loss and metrics; the
thinned sync; global-norm clipping; the warmup-cosine lr; the optimizer.

The parameters are a trainable tree in the JAX layout
(``backbone.train_specs``).  The step updates the state's tensors in
place (the reference donates its state): the returned state holds the
same parameter, master and moment tensors, and the state passed in must
not be read again.  ``rng`` is the step's JAX-layout key of the thinned
sync (``kernels.threefry.prng_key(step)`` as the CLIs pass it, or the
words of a ``jax.random.PRNGKey``), needed only with ``thinned_sync``: the
sync draws JAX's uniforms from it.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import backbone
from repro_torch.models.common import (trainable, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.train import compression, optim

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class TrainState(NamedTuple):
    step: torch.Tensor         # int32 0-d
    params: Any                # param_dtype, trainable, JAX layout
    master: Any                # fp32 master copy (adamw+master) or None
    opt: Any                   # optim.AdamWState / AdafactorState
    sync: Any                  # compression.SyncState or None


def init_train_state(run: RunConfig, gen: torch.Generator,
                     device=None) -> TrainState:
    """Fresh state: weights drawn from ``gen`` (a generator on
    ``device``, ``cuda:0`` unless named) in ``param_dtype``."""
    mcfg, tcfg = run.model, run.train
    device = resolve_device(device)
    pdtype = DTYPES[tcfg.param_dtype]
    params = backbone.init_train_params(mcfg, gen, pdtype, device)
    master = None
    if tcfg.optimizer == "adamw":
        # a separate fp32 master copy only for low-precision params
        if tcfg.master_weights and pdtype != torch.float32:
            master = tree_map(lambda p: p.detach().float(), params)
        opt = optim.adamw_init(params)
    else:
        opt = optim.adafactor_init(params)
    sync = compression.init_state(params) if tcfg.thinned_sync else None
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                      params=params, master=master, opt=opt, sync=sync)


def restore_train_state(manager, template: TrainState, step=None,
                        device=None) -> TrainState:
    """``manager.restore(template)`` (a ``CheckpointManager``) with the
    parameters made trainable again."""
    state = manager.restore(template, step, device=device)
    return state._replace(params=trainable(state.params))


def _split_micro(batch: dict, n_micro: int) -> list:
    out = []
    for i in range(n_micro):
        micro = {}
        for k, x in batch.items():
            B = x.shape[0]
            if B % n_micro:
                raise ValueError(f"batch of {B} rows does not split into "
                                 f"{n_micro} microbatches")
            m = B // n_micro
            micro[k] = x[i * m:(i + 1) * m]
        out.append(micro)
    return out


def _take_grads(leaves, acc_dtype) -> list:
    """The leaves' ``.grad`` in ``acc_dtype``, the ``.grad`` cleared."""
    out = []
    for p in leaves:
        g = p.grad
        if g is None:       # a leaf the loss does not reach
            g = torch.zeros_like(p)
        out.append(g.to(acc_dtype))
        p.grad = None
    return out


def make_train_step(run: RunConfig, *, total_steps: int = 10_000):
    mcfg, tcfg = run.model, run.train
    cdtype = DTYPES[tcfg.compute_dtype]
    acc_dtype = torch.float32 if (tcfg.master_weights
                                  or tcfg.optimizer == "adamw") \
        else torch.bfloat16

    def loss_fn(params, micro):
        return backbone.train_loss(
            params, mcfg, micro, compute_dtype=cdtype, remat=tcfg.remat,
            moe_aux_weight=tcfg.moe_aux_weight,
            moe_z_weight=tcfg.moe_z_weight)

    def grad_fn(params, micro):
        """The loss and metrics (detached); the gradients into .grad."""
        loss, metrics = loss_fn(params, micro)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: dict,
                   rng=None, micro_keep: Optional[torch.Tensor] = None):
        """One optimizer step.

        micro_keep: optional [grad_accum] bool — straggler mask; missing
        microbatches are dropped and survivors HT-reweighted (unbiased).
        """
        n_micro = tcfg.grad_accum
        leaves = tree_leaves(state.params)
        device = leaves[0].device
        for p in leaves:
            p.grad = None

        if n_micro == 1:
            loss, metrics = grad_fn(state.params, batch)
            grads = _take_grads(leaves, acc_dtype)
        else:
            keep = torch.ones(n_micro, dtype=torch.bool, device=device) \
                if micro_keep is None else \
                torch.as_tensor(micro_keep, device=device).bool()
            keep_frac = torch.mean(keep.float())
            grads = [torch.zeros(p.shape, dtype=acc_dtype, device=device)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            metrics = None
            for i, mb in enumerate(_split_micro(batch, n_micro)):
                kp = keep[i]
                l_i, met = grad_fn(state.params, mb)
                # straggler HT-reweighting: E[sum] = full-batch gradient
                w = compression.straggler_reweight(
                    torch.ones((), dtype=torch.float32, device=device), kp,
                    torch.clamp_min(keep_frac, 1e-6)) / n_micro
                with torch.no_grad():
                    for a, g in zip(grads, _take_grads(leaves, acc_dtype)):
                        a.add_(w.to(acc_dtype) * g)
                loss = loss + torch.where(kp, l_i, 0.0) / n_micro
                if metrics is None:
                    metrics = {k: torch.zeros((), dtype=torch.float32,
                                              device=device) for k in met}
                metrics = {k: metrics[k] + torch.where(kp, met[k], 0.0)
                           / n_micro for k in metrics}
        grads = tree_unflatten(state.params, grads)

        # ---- optional beyond-paper thinned gradient sync ----------------
        sync_state = state.sync
        if tcfg.thinned_sync:
            cfgc = compression.ThinnedSyncConfig(
                budget=tcfg.thinned_sync_budget,
                alpha=tcfg.thinned_sync_alpha)
            if rng is None:
                raise ValueError("thinned_sync needs the step's key (rng)")
            grads, sync_state, cmetrics = compression.thin_gradients(
                grads, state.sync, rng, cfgc)
            metrics = {**metrics, **cmetrics}

        grads, gnorm = optim.clip_by_global_norm(grads, tcfg.grad_clip)
        lr = optim.warmup_cosine(state.step, peak_lr=tcfg.learning_rate,
                                 warmup_steps=tcfg.warmup_steps,
                                 total_steps=total_steps)

        with torch.no_grad():
            if tcfg.optimizer == "adamw":
                # float32 params are their own master copy
                master = state.master if state.master is not None else \
                    tree_map(lambda p: p.detach() if p.dtype == torch.float32
                             else p.detach().float(), state.params)
                master, opt = optim.adamw_update(
                    grads, state.opt, master, lr=lr, beta1=tcfg.beta1,
                    beta2=tcfg.beta2, eps=1e-8,
                    weight_decay=tcfg.weight_decay, step=state.step)
                for p, m in zip(leaves, tree_leaves(master)):
                    if m.data_ptr() != p.data_ptr():
                        p.copy_(m)
                master_out = master if state.master is not None else None
            else:
                _, opt = optim.adafactor_update(
                    grads, state.opt, state.params, lr=lr,
                    weight_decay=tcfg.weight_decay, step=state.step)
                master_out = None

        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        metrics["loss"] = loss if n_micro > 1 else metrics.get("loss", loss)
        new_state = TrainState(step=state.step + 1, params=state.params,
                               master=master_out, opt=opt, sync=sync_state)
        return new_state, metrics

    return train_step

