"""Multi-family model backbone with train / prefill / decode / encode APIs
(PyTorch).

The counterpart of ``repro.models.backbone``.  A model is a *layer plan*

    prefix kinds  +  (pattern kinds) x n_groups  +  suffix kinds

with kinds ``attn`` (pre-norm GQA self-attention, + MLP when d_ff > 0),
``moe`` (pre-norm GQA self-attention + mixture of experts: ``ffn.moe``, or
``moe_ep.moe_ep`` when ``moe_impl == "ep_a2a"``), ``ssd`` (Mamba-2 SSD
block: norm + ssd, no MLP), ``rec`` (RG-LRU block + MLP) and ``cross``
(tanh-gated cross-attention over the vision memory ``image_embeds`` +
tanh-gated MLP).  Where the JAX package scans stacked group parameters,
the port keeps the layers as one Python list in execution order (the
prefix, then group by group, pattern position by pattern position, then
the suffix), and the decode state as one cache entry per layer.  Like the
reference, the decode runs the dense ``ffn.moe`` whatever ``moe_impl``
says (a decode step's few tokens do not divide over ranks).

Training keeps the parameters in the JAX layout instead (``train_specs``:
the prefix list, one stacked tree per pattern position in ``groups``, the
suffix list), because two computations of the reference are defined over
the stacked leaves: Adafactor's factoring and update clip, and the thinned
sync's blocks.  The forward reads layer g of a stack as a view (one
``unbind`` per stacked leaf), so the gradients land in the stacked leaf.
``forward_hidden`` takes either layout; with ``remat`` each group of
pattern layers is recomputed in the backward
(``torch.utils.checkpoint``, as the reference checkpoints ``group_body``),
and ``chunked_xent`` / ``train_loss`` are the reference's loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, common, ffn, mamba2, moe_ep, rglru
from repro_torch.models.attention import KVCache
from repro_torch.models.common import Params, Spec

VOCAB_ALIGN = 128  # the reference pads the vocab to a multiple of this
KINDS = ("attn", "moe", "ssd", "rec", "cross")
ZERO_METRICS = {"moe_aux_loss": 0.0, "moe_z_loss": 0.0, "moe_drop_frac": 0.0}


def padded_vocab(cfg) -> int:
    v = cfg.vocab_size
    return -(-v // VOCAB_ALIGN) * VOCAB_ALIGN


# ----------------------------------------------------------------- layer plan
@dataclasses.dataclass(frozen=True)
class LayerPlan:
    prefix: Tuple[str, ...]
    pattern: Tuple[str, ...]
    n_groups: int
    suffix: Tuple[str, ...]

    @property
    def kinds(self) -> Tuple[str, ...]:
        """Every layer's kind, in execution order."""
        return self.prefix + self.pattern * self.n_groups + self.suffix


def layer_plan(cfg) -> LayerPlan:
    if cfg.family == "ssm":
        pattern: Tuple[str, ...] = ("ssd",)
    elif cfg.family == "moe":
        pattern = ("moe",)
    elif cfg.family == "hybrid":
        pattern = tuple(cfg.block_pattern) or ("rec", "rec", "attn")
    elif cfg.family == "vlm":
        pattern = ("attn",) * (cfg.cross_attn_every - 1) + ("cross",)
    elif cfg.family in ("dense", "audio"):
        pattern = ("attn",)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    for kind in set(pattern) - set(KINDS):
        raise ValueError(f"unknown layer kind {kind!r}")
    prefix = ("attn",) * cfg.first_dense_layers
    body = cfg.num_layers - len(prefix)
    n_groups = body // len(pattern)
    suffix = pattern[: body % len(pattern)]
    return LayerPlan(prefix, pattern, n_groups, suffix)


# ------------------------------------------------------------------ specs
def _norm_spec(cfg) -> Spec:
    return Spec((cfg.d_model,), "ones")


def block_specs(kind: str, cfg) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    attn = attention.attn_specs(D, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, cfg.use_bias, cfg.qk_norm)
    if kind == "ssd":
        return {"ln": _norm_spec(cfg), "ssd": mamba2.ssd_specs(cfg)}
    if kind == "rec":
        return {"ln1": _norm_spec(cfg), "rglru": rglru.rglru_specs(cfg),
                "ln2": _norm_spec(cfg), "mlp": ffn.mlp_specs(D, F)}
    if kind == "attn":
        s = {"ln1": _norm_spec(cfg), "attn": attn}
        if F > 0:
            s["ln2"] = _norm_spec(cfg)
            s["mlp"] = ffn.mlp_specs(D, F, cfg.use_bias, cfg.mlp_gated)
        return s
    if kind == "moe":
        return {"ln1": _norm_spec(cfg), "attn": attn, "ln2": _norm_spec(cfg),
                "moe": ffn.moe_specs(D, cfg.moe_d_ff, cfg.num_experts_padded,
                                     cfg.num_shared_experts)}
    if kind == "cross":
        # the tanh gates start at 0, as the reference's: the layer then
        # passes its input through until trained
        return {"ln1": _norm_spec(cfg), "xattn": attn,
                "gate_attn": Spec((), "zeros"),
                "ln2": _norm_spec(cfg), "mlp": ffn.mlp_specs(D, F),
                "gate_mlp": Spec((), "zeros")}
    raise ValueError(kind)


def model_specs(cfg) -> dict:
    Vp = padded_vocab(cfg)
    if cfg.input_mode == "frames":
        embed = {"frame_proj": Spec((cfg.frame_dim, cfg.d_model)),
                 "frame_bias": Spec((cfg.d_model,), "zeros")}
    else:
        embed = {"tok": Spec((Vp, cfg.d_model), "embed")}
    s = {"embed": embed,
         "layers": [block_specs(k, cfg) for k in layer_plan(cfg).kinds],
         "final_norm": _norm_spec(cfg)}
    if cfg.input_mode == "frames" or not cfg.tie_embeddings:
        s["head"] = Spec((cfg.d_model, Vp))    # untied
    return s


def train_specs(cfg) -> dict:
    """The JAX layout: ``{embed, prefix, groups, suffix, final_norm[,
    head]}`` with ``groups`` a tuple of one stacked spec tree per pattern
    position ([n_groups, ...] leaves)."""
    plan = layer_plan(cfg)
    s = model_specs(cfg)
    del s["layers"]
    s["prefix"] = [block_specs(k, cfg) for k in plan.prefix]
    s["groups"] = tuple(common.stack_specs(block_specs(k, cfg), plan.n_groups)
                        for k in plan.pattern) if plan.n_groups else ()
    s["suffix"] = [block_specs(k, cfg) for k in plan.suffix]
    return s


def init_train_params(cfg, gen: torch.Generator, dtype=torch.float32,
                      device=None) -> dict:
    """Random weights in the JAX layout, as a trainable tree (each leaf
    requires gradients), drawn from ``gen`` (a generator on ``device``)."""
    return common.trainable(common.init_tree(
        train_specs(cfg), gen, dtype,
        device if device is not None else gen.device))


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Params:
    """Random weights drawn from ``gen`` (a generator on ``device``)."""
    return Params(common.init_tree(model_specs(cfg), gen, dtype,
                                   device if device is not None
                                   else gen.device))


def count_params(cfg) -> int:
    return common.count_params(model_specs(cfg))


def active_params(cfg) -> int:
    """Active parameters per token (MoE routes top_k of num_experts)."""
    if cfg.family != "moe":
        return count_params(cfg)
    n_moe = layer_plan(cfg).kinds.count("moe")
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    return count_params(cfg) - n_moe * per_expert * (cfg.num_experts_padded
                                                     - cfg.top_k)


# ------------------------------------------------------------------ forward
def _embed(params, cfg, inputs, compute_dtype):
    """Token ids [B, S] or, for frame input, frames [B, S, frame_dim]."""
    if cfg.input_mode == "frames":
        e = params["embed"]
        x = torch.matmul(inputs.to(compute_dtype),
                         e["frame_proj"].to(compute_dtype)) \
            + e["frame_bias"].to(compute_dtype)
    else:
        x = params["embed"]["tok"][inputs].to(compute_dtype)
    if cfg.scale_embeddings:
        # sqrt(d_model) rounded to the compute dtype, as a Python scalar:
        # no host-to-device copy (and its stream sync) per call
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype)
        x = x * scale.item()
    return x


def _attn_kwargs(cfg) -> dict:
    return dict(rope_theta=cfg.rope_theta, window=cfg.attn_window,
                softcap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
                norm_eps=cfg.norm_eps,
                use_rope=cfg.causal)    # the encoder (hubert) skips rope


def _vision(cfg, image_embeds, compute_dtype):
    if image_embeds is None:
        if "cross" in layer_plan(cfg).kinds:
            raise ValueError(f"{cfg.name}: cross-attention layers need "
                             f"image_embeds [B, {cfg.num_vision_tokens}, "
                             f"{cfg.d_model}]")
        return None
    return image_embeds.to(compute_dtype)


def apply_block(kind: str, p, x, cfg, positions, vision=None, *,
                collect_cache: bool = False):
    """One layer forward; ``vision`` is the memory of a ``cross`` layer.
    Returns (x, metrics, cache entry or None): ``metrics`` holds the MoE
    losses and drop fraction (0.0 for the other kinds)."""
    metrics = dict(ZERO_METRICS)
    if kind == "cross":
        kv = attention.cross_kv(p["xattn"], vision, qk_norm=cfg.qk_norm,
                                norm_eps=cfg.norm_eps)
        h = common.rms_norm(x, p["ln1"], cfg.norm_eps)
        out = attention.cross_attention(p["xattn"], h, kv,
                                        qk_norm=cfg.qk_norm,
                                        norm_eps=cfg.norm_eps)
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * out
        h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + torch.tanh(p["gate_mlp"]).to(x.dtype) * ffn.mlp(p["mlp"], h)
        return x, metrics, kv if collect_cache else None
    cache = None
    if kind == "ssd":
        h = common.rms_norm(x, p["ln"], cfg.norm_eps)
        out = mamba2.ssd_block(p["ssd"], h, cfg, return_state=collect_cache)
    else:
        h = common.rms_norm(x, p["ln1"], cfg.norm_eps)
        if kind == "rec":
            out = rglru.rglru_block(p["rglru"], h, cfg,
                                    return_state=collect_cache)
        elif kind in ("attn", "moe"):
            out = attention.self_attention(
                p["attn"], h, positions, causal=cfg.causal,
                return_kv=collect_cache, **_attn_kwargs(cfg))
        else:
            raise ValueError(kind)
    if collect_cache:
        out, cache = out
    x = x + out
    if kind == "moe":
        h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
        moe_fn = moe_ep.moe_ep if cfg.moe_impl == "ep_a2a" else ffn.moe
        y, m = moe_fn(p["moe"], h, num_experts=cfg.num_experts,
                      top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        metrics.update(m)
        x = x + y
    elif "mlp" in p:              # rec, and attn when d_ff > 0
        h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + ffn.mlp(p["mlp"], h)
    return x, metrics, cache


def _unstack(tree, n: int) -> list:
    """A stacked tree's n layers, each leaf a view of its stack."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[g] for k, v in per_key.items()} for g in range(n)]
    return list(tree.unbind(0))


def layer_sections(params, cfg):
    """(prefix layers, groups, suffix layers) of either layout: each group
    is the list of its pattern position's layers."""
    plan = layer_plan(cfg)
    P = len(plan.pattern)
    if "layers" in params:                    # the serving layout
        layers = list(params["layers"])
        n0 = len(plan.prefix)
        n1 = n0 + P * plan.n_groups
        groups = [layers[n0 + g * P:n0 + (g + 1) * P]
                  for g in range(plan.n_groups)]
        return layers[:n0], groups, layers[n1:]
    per_pos = [_unstack(stack, plan.n_groups) for stack in params["groups"]]
    groups = [[per_pos[i][g] for i in range(P)]
              for g in range(plan.n_groups)]
    return list(params["prefix"]), groups, list(params["suffix"])


def forward_hidden(params, cfg, inputs, *, compute_dtype=torch.bfloat16,
                   image_embeds=None, layer_metrics: Optional[list] = None,
                   remat: bool = False):
    """Embed + all layers + final norm.  inputs: tokens [B, S] (frames
    [B, S, frame_dim] for frame input) -> [B, S, D].  ``params`` in the
    serving layout or the JAX layout (``train_specs``).

    ``image_embeds`` [B, Nv, D] is the memory of the ``cross`` layers
    (the vision family needs it).  Each layer's metrics (``apply_block``)
    are appended to ``layer_metrics`` when a list is given; the
    reference's ``forward_hidden`` returns their sums (``train_loss``
    sums them).  ``remat``: each group of pattern layers is checkpointed
    (recomputed in the backward), as the reference checkpoints its scan
    body; the prefix and suffix layers are not."""
    plan = layer_plan(cfg)
    x = _embed(params, cfg, inputs, compute_dtype)
    vision = _vision(cfg, image_embeds, compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    prefix, groups, suffix = layer_sections(params, cfg)
    metrics = layer_metrics if layer_metrics is not None else []

    def run(kinds, layers, x):
        out = []
        for kind, p in zip(kinds, layers):
            x, m, _ = apply_block(kind, p, x, cfg, positions, vision)
            out.append(m)
        return x, out

    x, m = run(plan.prefix, prefix, x)
    metrics += m
    for layers in groups:
        if remat:
            x, m = checkpoint(run, plan.pattern, layers, x,
                              use_reentrant=False)
        else:
            x, m = run(plan.pattern, layers, x)
        metrics += m
    x, m = run(plan.suffix, suffix, x)
    metrics += m
    return common.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _head_weight(params, x_dtype):
    """The untied head, or the tied embedding transposed, in x_dtype."""
    if "head" in params:
        return params["head"].to(x_dtype)
    return params["embed"]["tok"].to(x_dtype).T    # tied


def logits_from_hidden(params, cfg, x) -> torch.Tensor:
    """Full-vocab logits, from the untied head or the tied embedding.
    [B, S, D] -> [B, S, Vp] float32."""
    logits = torch.matmul(x, _head_weight(params, x.dtype)).float()
    Vp = logits.shape[-1]
    if Vp > cfg.vocab_size:  # mask vocab padding
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# ------------------------------------------------------------------ decode
class DecodeState(NamedTuple):
    pos: int             # number of tokens already in context
    layers: tuple        # one cache entry per layer (KVCache / SSMState /
    #                      RGLRUState / the cross layers' static (k, v))


def _attn_cache_len(cfg, max_len: int) -> int:
    window = cfg.attn_window
    if window > 0:
        return min(window, max_len)
    return max_len


def init_block_cache(kind: str, cfg, batch: int, max_len: int, dtype,
                     device):
    if kind == "ssd":
        return mamba2.ssd_init_state(cfg, batch, dtype, device)
    if kind == "rec":
        return rglru.rglru_init_state(cfg, batch, dtype, device)
    if kind in ("attn", "moe"):
        return KVCache.zeros(batch, _attn_cache_len(cfg, max_len),
                             cfg.num_kv_heads, cfg.head_dim, dtype, device)
    if kind == "cross":
        shp = (batch, cfg.num_vision_tokens, cfg.num_kv_heads, cfg.head_dim)
        return (torch.zeros(shp, dtype=dtype, device=device),
                torch.zeros(shp, dtype=dtype, device=device))
    raise ValueError(kind)


def init_decode_state(cfg, batch: int, max_len: int, dtype,
                      device) -> DecodeState:
    return DecodeState(pos=0, layers=tuple(
        init_block_cache(k, cfg, batch, max_len, dtype, device)
        for k in layer_plan(cfg).kinds))


def decode_block(kind: str, p, cache, x, cfg, pos: int):
    """One layer of single-token decode.  Returns (x, new_cache)."""
    if kind == "ssd":
        h = common.rms_norm(x, p["ln"], cfg.norm_eps)
        out, cache = mamba2.ssd_decode_step(p["ssd"], h, cache, cfg)
        return x + out, cache
    h = common.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "cross":     # the memory's K/V stay as the prefill made them
        out = attention.decode_cross_attention(
            p["xattn"], h, cache, qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * out
        h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + torch.tanh(p["gate_mlp"]).to(x.dtype) * ffn.mlp(p["mlp"], h)
        return x, cache
    if kind == "rec":
        out, cache = rglru.rglru_decode_step(p["rglru"], h, cache, cfg)
    elif kind in ("attn", "moe"):
        out, cache = attention.decode_self_attention(
            p["attn"], h, cache, pos, **_attn_kwargs(cfg))
    else:
        raise ValueError(kind)
    x = x + out
    if kind == "moe":
        h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
        y, _ = ffn.moe(p["moe"], h, num_experts=cfg.num_experts,
                       top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        x = x + y
    elif "mlp" in p:
        h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + ffn.mlp(p["mlp"], h)
    return x, cache


def decode_step(params, cfg, state: DecodeState, token: torch.Tensor, *,
                compute_dtype=torch.bfloat16):
    """One decode step.  token: [B, 1] -> ([B, Vp] f32 logits, state).

    The attention caches are updated in place.
    """
    x = _embed(params, cfg, token, compute_dtype)
    caches = []
    for kind, p, c in zip(layer_plan(cfg).kinds, params["layers"],
                          state.layers):
        x, c = decode_block(kind, p, c, x, cfg, state.pos)
        caches.append(c)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, x)[:, 0]
    return logits, DecodeState(pos=state.pos + 1, layers=tuple(caches))


# ------------------------------------------------------------------ prefill
def _fill_kv_cache(cfg, kv, max_len: int, dtype) -> KVCache:
    """Place prefill K/V [B, S, Kh, D] into a (possibly ring) cache: the
    last min(S, L) tokens, token t in slot t % L."""
    k, v = kv
    B, S = k.shape[:2]
    L = _attn_cache_len(cfg, max_len)
    cache = KVCache.zeros(B, L, cfg.num_kv_heads, cfg.head_dim, dtype,
                          k.device)
    take = min(S, L)
    ts = torch.arange(S - take, S, device=k.device)
    slots = ts % L if cfg.attn_window > 0 else ts
    cache.k[:, slots] = k[:, ts].to(dtype)
    cache.v[:, slots] = v[:, ts].to(dtype)
    return cache


def prefill(params, cfg, tokens, *, max_len: Optional[int] = None,
            compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
            image_embeds=None, layer_metrics: Optional[list] = None):
    """Process the prompt [B, S]; return ([B, Vp] f32 last-position logits,
    DecodeState).  ``image_embeds`` and ``layer_metrics`` as in
    ``forward_hidden``; a cross layer's cache is its memory K/V in the
    compute dtype, as the reference keeps it."""
    x = _embed(params, cfg, tokens, compute_dtype)
    vision = _vision(cfg, image_embeds, compute_dtype)
    S = x.shape[1]
    max_len = max_len or S
    positions = torch.arange(S, device=x.device)
    caches = []
    for kind, p in zip(layer_plan(cfg).kinds, params["layers"]):
        x, m, c = apply_block(kind, p, x, cfg, positions, vision,
                              collect_cache=True)
        if layer_metrics is not None:
            layer_metrics.append(m)
        if kind in ("attn", "moe"):
            c = _fill_kv_cache(cfg, c, max_len, cache_dtype)
        caches.append(c)
    x = common.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, x)[:, 0]
    return logits, DecodeState(pos=S, layers=tuple(caches))


def encode(params, cfg, frames, *, compute_dtype=torch.bfloat16):
    """Encoder-only serve step (hubert): frames [B, S, frame_dim] ->
    full-sequence logits [B, S, Vp] float32."""
    x = forward_hidden(params, cfg, frames, compute_dtype=compute_dtype)
    return logits_from_hidden(params, cfg, x)


# ------------------------------------------------------------------ training
def chunked_xent(params, cfg, x, labels, valid, *, seq_chunk: int = 512):
    """Cross-entropy without materialising [B, S, V] logits.

    x: [B, S, D]; labels: [B, S] int64; valid: [B, S] bool.  The sequence
    is cut into chunks (the largest of ``seq_chunk``, halved, that divides
    S); each chunk's head product and float32 log-sum-exp are checkpointed
    (recomputed in the backward), so the peak is [B, chunk, Vp] float32.
    Returns (mean cross-entropy over the valid tokens, {accuracy, tokens}).
    """
    S = x.shape[1]
    V = cfg.vocab_size
    chunk = min(seq_chunk, S)
    while S % chunk:
        chunk //= 2

    def one_chunk(xc, lc, vc):
        logits = torch.matmul(xc, _head_weight(params, xc.dtype)).float()
        if logits.shape[-1] > V:
            pad = torch.arange(logits.shape[-1], device=x.device) >= V
            logits = torch.where(pad, -1e30, logits)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc[..., None])[..., 0]
        ce = torch.where(vc, lse - ll, 0.0)
        correct = vc & (torch.argmax(logits, -1) == lc)
        return ce.sum(), vc.sum(), correct.sum()

    ce_sum = n_valid = n_correct = 0
    for i in range(0, S, chunk):
        ce, nv, nc = checkpoint(one_chunk, x[:, i:i + chunk],
                                labels[:, i:i + chunk],
                                valid[:, i:i + chunk], use_reentrant=False)
        ce_sum, n_valid, n_correct = ce_sum + ce, n_valid + nv, \
            n_correct + nc
    total = torch.clamp_min(n_valid, 1)
    return ce_sum / total, {"accuracy": n_correct / total,
                            "tokens": total.float()}


def train_loss(params, cfg, batch: dict, *, compute_dtype=torch.bfloat16,
               remat: bool = True, moe_aux_weight: float = 0.01,
               moe_z_weight: float = 1e-3, seq_chunk: int = 512):
    """Next-token LM loss (labels for frame input and encoders), plus the
    MoE aux and z terms.  ``batch``: ``tokens`` [B, S] (or ``frames``
    [B, S, frame_dim] and ``labels`` [B, S], -1 = no label) and, for the
    vision family, ``image_embeds``.  Returns (loss, metrics): the summed
    MoE metrics, accuracy, tokens, ce_loss and loss (0-d float32)."""
    if cfg.family == "moe" and cfg.moe_impl == "ep_a2a":
        raise NotImplementedError(
            f"{cfg.name}: training through moe_ep (moe_impl='ep_a2a') is not "
            f"ported; use moe_impl='spmd'")
    frames = cfg.input_mode == "frames"
    layer_metrics: list = []
    x = forward_hidden(params, cfg, batch["frames" if frames else "tokens"],
                       compute_dtype=compute_dtype,
                       image_embeds=batch.get("image_embeds"),
                       layer_metrics=layer_metrics, remat=remat)
    if frames or not cfg.causal:
        labels = batch["labels"].long()
        valid = labels >= 0
        labels = torch.clamp_min(labels, 0)
    else:
        tok = batch["tokens"].long()
        labels = torch.cat([tok[:, 1:], torch.zeros_like(tok[:, :1])], 1)
        valid = torch.ones_like(labels, dtype=torch.bool)
        valid[:, -1] = False
    ce, ce_metrics = chunked_xent(params, cfg, x, labels, valid,
                                  seq_chunk=seq_chunk)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    metrics = {}
    for k in ZERO_METRICS:
        total = zero
        for m in layer_metrics:
            total = total + m[k]
        metrics[k] = total
    loss = ce
    if cfg.family == "moe":
        loss = loss + moe_aux_weight * metrics["moe_aux_loss"] \
            + moe_z_weight * metrics["moe_z_loss"]
    metrics.update(ce_metrics)
    metrics["ce_loss"] = ce
    metrics["loss"] = loss
    return loss, metrics
