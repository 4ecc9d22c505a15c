"""Beyond-paper: HT-thinned gradient synchronization with error feedback
(PyTorch port of ``repro.train.compression``).

The paper's mechanism — Bernoulli-gate expensive persistence operations with
Horvitz-Thompson reweighting, budget-constrained inclusion probabilities and
variance-aware tilting (Eq. 4) — transplants directly onto the most expensive
"persistence path" of distributed *training*: the cross-pod gradient
all-reduce over DCN (25x slower than ICI).

Per gradient block (contiguous chunk of each tensor):
  p_blk = sigmoid( logit(budget) + alpha * (|g_blk| - mu)/sigma )   (Eq. 4)
  Z_blk ~ Bernoulli(p_blk)
with two reweighting modes:

  mode='ht'  synced = Z * g / p  — Horvitz-Thompson, exactly unbiased per
             step (the paper's estimator), variance instead of bias, NO
             error feedback.
  mode='ef'  synced = Z * (g + err); err' = (g + err) - synced — biased per
             step, error feedback (Karimireddy et al.) recovers the signal
             over steps.

These must NOT be combined: error feedback assumes a *contractive*
compressor (||x - C(x)|| <= (1-d)||x||), while HT reweighting is expansive
(|1 - 1/p| > 1 for p < 1), so EF-on-HT is a positive feedback loop that
diverges geometrically — we validated this empirically
(tests/test_train.py::test_ht_plus_ef_diverges, and
tests/test_torch_train.py for the port) and expose the two sound
modes instead.

In SPMD, the cross-pod reduction volume is what this shrinks: a zero block is
never transmitted by a sparse collective; with dense collectives the
compressed tensor is what a custom reducer would send.  We expose
``sync_volume_fraction`` so benchmarks can report the traffic reduction.

The uniforms are JAX's bits: ``thin_gradients`` takes a JAX-layout key
(``prng_key(seed)``, or the words of a ``jax.random.PRNGKey``), splits it
into one key a leaf in JAX's leaf order and draws a leaf's uniforms from its
key, with ``kernels.threefry.split`` and ``uniform`` (jax 0.9's
``jax.random.split`` and ``jax.random.uniform``), so both packages thin the
same blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.kernels import threefry
from repro_torch.models.common import (tree_leaves, tree_map,
                                       tree_unflatten)


@dataclasses.dataclass(frozen=True)
class ThinnedSyncConfig:
    budget: float = 0.25       # target synced fraction of blocks
    alpha: float = 2.0         # variance-aware tilt (0 = uniform thinning)
    block: int = 1024          # elements per block
    min_p: float = 1e-3
    mode: str = "ht"           # 'ht' (unbiased, no EF) | 'ef' (biased + EF)

    def __post_init__(self):
        if self.mode not in ("ht", "ef"):
            raise ValueError(f"unknown thinned-sync mode {self.mode!r}")


class SyncState(NamedTuple):
    err: Any                   # error-feedback buffers, like grads (fp32)


def init_state(grads) -> SyncState:
    return SyncState(err=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def _logit(p: float) -> torch.Tensor:
    p = torch.clamp(torch.tensor(p, dtype=torch.float32), 1e-6, 1 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def _thin_one(g: torch.Tensor, err: torch.Tensor, u: torch.Tensor,
              cfg: ThinnedSyncConfig):
    """Thin one tensor with the uniforms ``u`` (at least one a block).
    Returns (synced, new_err, kept_blocks, n_blocks)."""
    g32 = g.float() + err if cfg.mode == "ef" else g.float()
    flat = g32.reshape(-1)
    n = flat.shape[0]
    nb = -(-n // cfg.block)
    fp = torch.nn.functional.pad(flat, (0, nb * cfg.block - n)).reshape(
        nb, cfg.block)

    mag = torch.sqrt(torch.mean(fp * fp, dim=1))           # block RMS
    mu = torch.mean(mag)
    sd = torch.std(mag, correction=0) + 1e-12
    zscore = torch.clamp((mag - mu) / sd, -8.0, 8.0)
    p = torch.sigmoid(_logit(cfg.budget).to(g.device) + cfg.alpha * zscore)
    p = torch.clamp(p, cfg.min_p, 1.0)

    z = u[:nb] < p
    if cfg.mode == "ht":
        scale = torch.where(z, 1.0 / p, 0.0)                # HT: unbiased
        synced = (fp * scale[:, None]).reshape(-1)[:n].reshape(g.shape)
        new_err = torch.zeros_like(err)                     # no feedback
    else:
        sel = fp * z[:, None].to(fp.dtype)                  # EF: biased
        synced = sel.reshape(-1)[:n].reshape(g.shape)
        new_err = g32 - synced.float()                      # residual
    return synced.to(g.dtype), new_err, torch.sum(z), nb


def thin_gradients(grads, state: SyncState, rng, cfg: ThinnedSyncConfig):
    """Apply HT-thinned sync to a gradient tree: ``rng`` (a JAX-layout key)
    split into one key a leaf, in JAX's leaf order, and one uniform a block
    drawn from the leaf's key on the gradients' device, as the reference
    draws them.

    Returns (synced_grads, new_state, metrics) where metrics holds
    ``sync_volume_fraction``, the fraction of blocks actually sent.
    """
    leaves = tree_leaves(grads)
    keys = threefry.split(rng, len(leaves))
    out, errs, kept, total = [], [], 0, 0
    for g, e, k in zip(leaves, tree_leaves(state.err), keys):
        nb = -(-g.numel() // cfg.block)
        u = threefry.uniform(k, nb, g.device)
        s, ne, kb, b = _thin_one(g, e, u, cfg)
        out.append(s)
        errs.append(ne)
        kept = kept + kb
        total = total + b
    synced = tree_unflatten(grads, out)
    err = tree_unflatten(grads, errs)
    metrics = {"sync_volume_fraction": kept / max(total, 1)}
    return synced, SyncState(err=err), metrics


# ------------------------------------------------- straggler mitigation
def straggler_reweight(micro_grads_mean, keep, keep_prob):
    """HT-reweight a microbatch gradient under straggler dropping.

    keep: bool (this microbatch arrived in time); keep_prob: its inclusion
    probability.  E[reweighted] equals the full-participation gradient —
    the paper's estimator, applied to gradient accumulation.
    """
    w = torch.where(keep, 1.0 / torch.clamp_min(keep_prob, 1e-6), 0.0)
    return micro_grads_mean * w
