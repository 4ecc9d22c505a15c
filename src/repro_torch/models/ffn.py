"""Feed-forward block (PyTorch): the gated SwiGLU MLP.

The counterpart of ``repro.models.ffn.mlp_specs`` / ``mlp`` on the path
RecurrentGemma takes (gated, no biases); the GELU branch and MoE are not
ported.
"""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.common import Spec


def mlp_specs(d_model: int, d_ff: int) -> dict:
    return {"w_up": Spec((d_model, d_ff)),
            "w_down": Spec((d_ff, d_model)),
            "w_gate": Spec((d_model, d_ff))}


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D], in x's dtype."""
    u = torch.matmul(x, p["w_up"].to(x.dtype))
    g = torch.matmul(x, p["w_gate"].to(x.dtype))
    return torch.matmul(common.swiglu(g, u), p["w_down"].to(x.dtype))
