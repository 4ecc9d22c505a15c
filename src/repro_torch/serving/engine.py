"""Serving plane (PyTorch): serve_step factories and a batched generate loop.

The counterpart of ``repro.serving.engine``:

  prefill  (params, tokens [B, S][, image_embeds [B, Nv, D]][,
            layer_metrics])               -> (last logits, DecodeState)
  decode   (params, state, tokens [B, 1]) -> (logits [B, Vp], DecodeState)
  encode   (params, frames [B, S, F])     -> logits [B, S, Vp]  (encoder)

An encoder-only architecture (``causal=False``) has no decode step: its
"prefill" step is the encoder, and a decode step is refused.  The vision
family's prefill takes the precomputed patch embeddings ``image_embeds``
(the JAX batch's ``"image_embeds"``); its decode reads their K/V from the
state.  A list passed as ``layer_metrics`` receives each layer's MoE
metrics (``backbone.prefill``).

``generate`` drives prefill + greedy/temperature decode.  Greedy decoding
is the same function as the reference's; sampling at a temperature above
0 draws from a ``torch.Generator``, whose numbers differ from JAX's.  The
reference's ``generate`` gives the vision family no memory, so it fails
there; the port's refuses the family with a ``ValueError``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import RunConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import context as dctx
from repro_torch.models import backbone
from repro_torch.models.common import tree_leaves, tree_map


def _serving(params, mcfg, batch=None):
    """(parameters in the serving layout, the ``gather`` to run them
    with, the context to run them in): sharded parameters (DTensor
    leaves, the JAX layout) are gathered a layer at a time where the step
    uses them, over the mesh's other axes, the rank keeping its
    ``"model"`` shards where the installed rules give the model a
    tensor-parallel split (``distributed.context.tp_context``), the mesh
    dims that split the ``batch`` tensor's rows installed beside
    (``batch_context``: the MoE routes over the whole batch); others are
    run as they are."""
    leaves = tree_leaves(params)
    if not leaves or not isinstance(leaves[0], DTensor):
        return params, None, contextlib.nullcontext()
    mesh, rules = leaves[0].device_mesh, dctx.get_rules()
    keep = dctx.split_model_dim(mesh) if rules is not None else None

    def gather(t, whole=False):
        k = None if whole else keep
        return tree_map(lambda p: collectives.local_part(
            p, [pl if i == k else Replicate()
                for i, pl in enumerate(p.placements)]), t)
    return backbone.serving_params(params, mcfg), gather, _step_context(
        mesh if keep is not None else None, rules, mesh, _row_dims(batch))


@contextlib.contextmanager
def _step_context(tp_mesh, rules, mesh, dims):
    with dctx.tp_context(tp_mesh, rules), \
            dctx.batch_context(mesh, dims, rules):
        yield


def _row_dims(x) -> tuple:
    """The mesh dims that shard a DTensor's rows (none for a plain
    tensor: every rank holds them all)."""
    if not isinstance(x, DTensor):
        return ()
    return tuple(i for i, p in enumerate(x.placements)
                 if p.is_shard() and p.dim == 0)


def _rows(x, keep: Optional[int] = None):
    """This rank's batch rows of a DTensor (and its shard on mesh dim
    ``keep``; every other dim gathered); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return collectives.local_part(x, [
        p if i == keep or (p.is_shard() and p.dim == 0) else Replicate()
        for i, p in enumerate(x.placements)])


def _local_state(state, mcfg):
    """A decode state of DTensors (placed by ``decode_state_axes``) as the
    rank holds it under the installed split: its batch rows, its slots of
    an attention cache, its channels of an RG-LRU state and heads of an
    SSD one; an SSD conv state and a cross layer's memory whole (their
    split dims are not the rank's compute's)."""
    leaves = tree_leaves(state.layers)
    keep = None
    if leaves and isinstance(leaves[0], DTensor) and \
            dctx.get_rules() is not None:
        keep = dctx.split_model_dim(leaves[0].device_mesh)
    layers = []
    for kind, c in zip(backbone.layer_plan(mcfg).kinds, state.layers):
        if kind == "ssd":
            c = type(c)(conv=_rows(c.conv), h=_rows(c.h, keep))
        elif kind == "cross":
            c = tree_map(_rows, c)
        else:
            c = tree_map(lambda x: _rows(x, keep), c)
        layers.append(c)
    return backbone.DecodeState(pos=state.pos, layers=tuple(layers),
                                max_len=state.max_len)


def make_serve_step(run: RunConfig, kind: str, *,
                    compute_dtype=torch.bfloat16,
                    max_len: Optional[int] = None):
    """The serve step of ``kind``.  Under a mesh (parameters as DTensors
    in the JAX layout, ``launch.shardings``) the step gathers each layer's
    parameters over the data axes where it runs the layer and, under the
    installed rules, runs the model tensor-parallel over ``"model"`` (each
    rank on its heads, channels and vocab columns); it serves this rank's
    rows of the batch and returns them.  The decode state holds the rank's
    rows and, where the rules split them, its ``kv_seq`` slots of every
    attention cache: a decode step attends them where they lie and merges
    the ranks' partial softmaxes, moving no slot."""
    mcfg = run.model
    if kind == "prefill":
        if not mcfg.causal:
            def encode_step(params, frames):
                params, gather, tp = _serving(params, mcfg, frames)
                with tp:
                    return backbone.encode(params, mcfg, _rows(frames),
                                           compute_dtype=compute_dtype,
                                           gather=gather)
            return encode_step

        def prefill_step(params, tokens, image_embeds=None,
                         layer_metrics=None):
            params, gather, tp = _serving(params, mcfg, tokens)
            with tp:
                return backbone.prefill(
                    params, mcfg, _rows(tokens), max_len=max_len,
                    compute_dtype=compute_dtype, cache_dtype=compute_dtype,
                    image_embeds=None if image_embeds is None
                    else _rows(image_embeds),
                    layer_metrics=layer_metrics, gather=gather)
        return prefill_step

    if kind == "decode":
        if not mcfg.causal:
            raise ValueError(f"{mcfg.name} is encoder-only: it has no "
                             f"decode step")

        def decode_step(params, state, tokens):
            params, gather, tp = _serving(params, mcfg, tokens)
            state = _local_state(state, mcfg)
            with tp:
                return backbone.decode_step(params, mcfg, state,
                                            _rows(tokens),
                                            compute_dtype=compute_dtype,
                                            gather=gather)
        return decode_step

    raise ValueError(kind)


def sample_token(logits: torch.Tensor, gen: Optional[torch.Generator], *,
                 temperature: float, vocab_size: int) -> torch.Tensor:
    """logits: [B, Vp] -> [B, 1] int64 (greedy at temperature 0)."""
    Vp = logits.shape[-1]
    if Vp > vocab_size:
        logits = logits.clone()
        logits[:, vocab_size:] = -1e30
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)[:, None]
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)


@torch.inference_mode()
def generate(run: RunConfig, params, prompt_tokens: torch.Tensor, *,
             max_new_tokens: int, temperature: float = 0.0,
             gen: Optional[torch.Generator] = None,
             compute_dtype=torch.float32) -> torch.Tensor:
    """Batched autoregressive generation.  prompt: [B, S] -> [B, S + new]."""
    mcfg = run.model
    if mcfg.family == "vlm":
        raise ValueError(f"{mcfg.name}: generate takes no image_embeds; "
                         f"serve the vision family through make_serve_step")
    B, S = prompt_tokens.shape
    if S == 0:
        raise ValueError("generate requires a non-empty prompt "
                         "(prompt_tokens has sequence length 0)")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    logits, state = backbone.prefill(
        params, mcfg, prompt_tokens, max_len=S + max_new_tokens,
        compute_dtype=compute_dtype, cache_dtype=compute_dtype)
    tok = sample_token(logits, gen, temperature=temperature,
                       vocab_size=mcfg.vocab_size)
    out = [prompt_tokens, tok]
    for _ in range(max_new_tokens - 1):
        logits, state = backbone.decode_step(params, mcfg, state, tok,
                                             compute_dtype=compute_dtype)
        tok = sample_token(logits, gen, temperature=temperature,
                           vocab_size=mcfg.vocab_size)
        out.append(tok)
    return torch.cat(out, dim=1)
