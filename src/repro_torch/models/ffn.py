"""Feed-forward block (PyTorch): the gated SwiGLU MLP and the ungated GELU
MLP, each with optional biases.

The counterpart of ``repro.models.ffn.mlp_specs`` / ``mlp``; MoE is not
ported.
"""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.common import Spec


def mlp_specs(d_model: int, d_ff: int, use_bias: bool = False,
              gated: bool = True) -> dict:
    s = {"w_up": Spec((d_model, d_ff)),
         "w_down": Spec((d_ff, d_model))}
    if gated:
        s["w_gate"] = Spec((d_model, d_ff))
    if use_bias:
        s["b_up"] = Spec((d_ff,), "zeros")
        s["b_down"] = Spec((d_model,), "zeros")
        if gated:
            s["b_gate"] = Spec((d_ff,), "zeros")
    return s


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D], in x's dtype."""
    u = torch.matmul(x, p["w_up"].to(x.dtype))
    if "b_up" in p:
        u = u + p["b_up"].to(x.dtype)
    if "w_gate" in p:       # SwiGLU
        g = torch.matmul(x, p["w_gate"].to(x.dtype))
        if "b_gate" in p:
            g = g + p["b_gate"].to(x.dtype)
        h = common.swiglu(g, u)
    else:                       # ungated GELU (hubert / wav2vec2 family)
        h = common.gelu(u)
    out = torch.matmul(h, p["w_down"].to(x.dtype))
    if "b_down" in p:
        out = out + p["b_down"].to(x.dtype)
    return out
