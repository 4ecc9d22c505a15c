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
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import RunConfig
from repro_torch.core.types import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed import context as dctx
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
    if isinstance(next(iter(batch.values())), DTensor):
        return _split_micro_mesh(batch, n_micro)
    parts = {k: _split_rows(x, n_micro) for k, x in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


def _split_micro_mesh(batch: dict, n_micro: int) -> list:
    """A sharded batch's micro-batches, each the rows the single-process
    split gives it (micro-batch i is global rows [i m, (i + 1) m)), then
    sharded as the batch is: the batch is gathered (its inputs are small
    next to the state) and each rank keeps its chunk of every
    micro-batch."""
    out = [{} for _ in range(n_micro)]
    for k, x in batch.items():
        mesh = x.device_mesh
        for i, part in enumerate(_split_rows(collectives.whole(x),
                                             n_micro)):
            out[i][k] = distribute_tensor(part, mesh, _rows_placements(
                mesh, part, x.placements), src_data_rank=None)
    return out


def _rows_placements(mesh, part: torch.Tensor, placements) -> list:
    """A micro-batch's placements: the batch's data axes where its rows
    divide over them, else (under the rule table) the batch rule's
    fallback, as ``pspec_for`` picks for a batch of that many rows."""
    if dctx.get_rules() is None:
        return list(placements)
    return dctx.placements_for(mesh, part.shape,
                               ("batch",) + (None,) * (part.dim() - 1))


def _split_rows(x: torch.Tensor, n_micro: int) -> list:
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch of {B} rows does not split into "
                         f"{n_micro} microbatches")
    m = B // n_micro
    return [x[i * m:(i + 1) * m] for i in range(n_micro)]


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

    def loss_fn(params, micro, gather=None):
        return backbone.train_loss(
            params, mcfg, micro, compute_dtype=cdtype, remat=tcfg.remat,
            moe_aux_weight=tcfg.moe_aux_weight,
            moe_z_weight=tcfg.moe_z_weight, gather=gather)

    def grad_fn(params, micro):
        """The loss and metrics (detached); the gradients into .grad.
        Under a mesh (DTensor parameters, a batch sharded over the data
        axes) each rank runs the model on its batch shard and, under the
        installed rules, tensor-parallel over the mesh's ``"model"`` axis
        (``distributed.context.tp_context``): each layer's parameters are
        gathered over the other axes where the layer runs (``_Gather``;
        again in remat's recompute, as FSDP re-gathers), keeping the
        rank's ``"model"`` shards, or whole for a block that runs whole.
        The loss it differentiates is its share of the global token mean,
        so the gradients' sum over the data axes is the single-process
        gradient.  The batch context (``distributed.context.
        batch_context``) tells the model which ranks split the batch: the
        MoE routes over the whole batch as the single program does
        (``ffn.route_over``), and ``moe_ep`` runs over the mesh's
        ``"model"`` axis.  No ``mesh_context`` is installed for the model
        itself (its activations are plain tensors)."""
        data = _data_dims(micro)
        if data is None:
            loss, metrics = loss_fn(params, micro)
            loss.backward()
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}
        mesh = next(iter(micro.values())).device_mesh
        local = {k: x.to_local() for k, x in micro.items()}
        rules = dctx.get_rules()
        keep = dctx.split_model_dim(mesh) if rules is not None else None

        def gather(t, whole=False):
            k = None if whole else keep
            return tree_map(lambda p: _Gather.apply(p, data, k), t)
        # the recompute runs in here too
        with dctx.mesh_context(None), dctx.tp_context(
                mesh if keep is not None else None, rules), \
                dctx.batch_context(mesh, data, rules):
            loss, metrics = loss_fn(params, local, gather=gather)
            n = metrics["tokens"].detach()
            total = _sum_over(n, mesh, data)
            (loss * (n / total)).backward()
        metrics = {k: total if k == "tokens" else
                   _sum_over(v.detach() * (n / total), mesh, data)
                   for k, v in metrics.items()}
        return metrics["loss"], metrics

    def train_step(state: TrainState, batch: dict,
                   rng=None, micro_keep: Optional[torch.Tensor] = None):
        """One optimizer step.

        micro_keep: optional [grad_accum] bool — straggler mask; missing
        microbatches are dropped and survivors HT-reweighted (unbiased).
        """
        leaves = tree_leaves(state.params)
        if not isinstance(leaves[0], DTensor):
            return _step(state, batch, rng, micro_keep)
        # every scalar (the lr, the HT weights, the clip scale) is the
        # same on every rank: let it meet the DTensors as a replica
        with implicit_replication():
            return _step(state, batch, rng, micro_keep)

    def _step(state, batch, rng, micro_keep):
        n_micro = tcfg.grad_accum
        leaves = tree_leaves(state.params)
        device = _local(leaves[0]).device
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
            grads = [torch.zeros_like(p, dtype=acc_dtype) for p in leaves]
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

        if acc_dtype == torch.float32:
            grads, gnorm = optim.clip_by_global_norm(grads, tcfg.grad_clip)
            grad_scale = None
        else:
            # a bfloat16 accumulator: Adafactor applies the clip's scale in
            # float32 and keeps the product unrounded, as the reference's
            # fused step does (optim.adafactor_update)
            grad_scale, gnorm = optim.clip_scale(grads, tcfg.grad_clip)
            grad_scale = grad_scale.to(acc_dtype)
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
                    # a float32 parameter without a master copy is its
                    # own master (updated in place already)
                    if state.master is not None or p.dtype != torch.float32:
                        p.copy_(m)
                master_out = master if state.master is not None else None
            else:
                _, opt = optim.adafactor_update(
                    grads, state.opt, state.params, lr=lr,
                    weight_decay=tcfg.weight_decay, step=state.step,
                    grad_scale=grad_scale)
                master_out = None

        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        metrics["loss"] = loss if n_micro > 1 else metrics.get("loss", loss)
        new_state = TrainState(step=state.step + 1, params=state.params,
                               master=master_out, opt=opt, sync=sync_state)
        return new_state, metrics

    return train_step


# ---------------------------------------------------------- under a mesh
def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _data_dims(batch: dict) -> Optional[tuple]:
    """The mesh dims a DTensor batch is sharded over (its data axes), or
    None for a plain batch."""
    x = next(iter(batch.values()))
    if not isinstance(x, DTensor):
        return None
    return tuple(i for i, pl in enumerate(x.placements) if pl.is_shard())


def _sum_over(x: torch.Tensor, mesh, dims: tuple) -> torch.Tensor:
    """``x`` (a rank's 0-d value) summed over the mesh dims ``dims``."""
    placements = [Partial() if i in dims else Replicate()
                  for i in range(mesh.ndim)]
    return collectives.whole(DTensor.from_local(x, mesh, placements,
                                                run_check=False))


class _Gather(torch.autograd.Function):
    """A DTensor parameter gathered for the rank's compute: over every
    mesh dim but ``keep`` (the ``"model"`` dim, whose shard the rank
    computes on; None: whole).  Its gradient, a rank's share over the data
    axes ``data`` (every rank of the other axes computing the same, and a
    kept shard's gradient complete on its rank), is reduced back onto the
    parameter's placements: DTensor turns the data axes' ``Partial`` into
    a reduce-scatter where the parameter is sharded and an all-reduce
    where it is replicated."""

    @staticmethod
    def forward(ctx, p, data: tuple, keep: Optional[int]):
        ctx.mesh, ctx.placements, ctx.data, ctx.keep = \
            p.device_mesh, p.placements, data, keep
        ctx.shape, ctx.stride = p.shape, p.stride()
        return collectives.local_part(p, [
            pl if i == keep else Replicate()
            for i, pl in enumerate(p.placements)])

    @staticmethod
    def backward(ctx, g):
        placements = [Partial() if i in ctx.data else
                      ctx.placements[i] if i == ctx.keep else Replicate()
                      for i in range(ctx.mesh.ndim)]
        return DTensor.from_local(g.contiguous(), ctx.mesh, placements,
                                  run_check=False, shape=ctx.shape,
                                  stride=ctx.stride).redistribute(
            ctx.mesh, ctx.placements), None, None
