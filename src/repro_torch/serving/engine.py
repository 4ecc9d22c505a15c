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

from typing import Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import backbone


def make_serve_step(run: RunConfig, kind: str, *,
                    compute_dtype=torch.bfloat16,
                    max_len: Optional[int] = None):
    mcfg = run.model
    if kind == "prefill":
        if not mcfg.causal:
            def encode_step(params, frames):
                return backbone.encode(params, mcfg, frames,
                                       compute_dtype=compute_dtype)
            return encode_step

        def prefill_step(params, tokens, image_embeds=None,
                         layer_metrics=None):
            return backbone.prefill(params, mcfg, tokens, max_len=max_len,
                                    compute_dtype=compute_dtype,
                                    cache_dtype=compute_dtype,
                                    image_embeds=image_embeds,
                                    layer_metrics=layer_metrics)
        return prefill_step

    if kind == "decode":
        if not mcfg.causal:
            raise ValueError(f"{mcfg.name} is encoder-only: it has no "
                             f"decode step")

        def decode_step(params, state, tokens):
            return backbone.decode_step(params, mcfg, state, tokens,
                                        compute_dtype=compute_dtype)
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
