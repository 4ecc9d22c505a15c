"""Shared model machinery (PyTorch): parameter descriptors and trees,
norms, rope, the gated activation.

The counterpart of ``repro.models.common``, cut to what the serving and
training paths use.  A model is declared as a tree of ``Spec``
descriptors; ``init_tree`` draws each leaf in float32 from one
``torch.Generator`` and casts it, and ``Params`` holds the resulting tree
as an ``nn.Module`` whose leaves keep the JAX package's shapes, so that
``params["attn"]["wq"]`` reads like the JAX tree.  Serving freezes the
leaves; training holds its parameters as a plain tree (dicts, lists,
tuples) of leaf tensors that require gradients (``trainable``), walked in
JAX's flatten order by ``tree_leaves`` / ``tree_map``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn


class Spec(NamedTuple):
    """Parameter descriptor: shape + initializer."""

    shape: tuple
    init: str = "normal"   # normal | zeros | ones | embed | ssm_a | ssm_dt
    #                        | rglru_a
    fan_in: Optional[int] = None


SLAB_ELEMENTS = 1 << 30   # the largest float32 draw of one leaf (4 GiB)


def init_param(spec: Spec, gen: torch.Generator, dtype,
               device) -> torch.Tensor:
    """One leaf, drawn in float32 from ``gen`` (on ``device``), then cast."""
    f32 = dict(dtype=torch.float32, device=device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "ssm_a":  # mamba2 A_log in [1, 16]
        u = torch.rand(spec.shape, generator=gen, **f32) * (16.0 - 1.0) + 1.0
        return torch.log(u).to(dtype)
    if spec.init == "ssm_dt":  # dt bias ~ softplus-inverse of U[1e-3, 1e-1]
        u = torch.rand(spec.shape, generator=gen, **f32) * (1e-1 - 1e-3) \
            + 1e-3
        return (u + torch.log(-torch.expm1(-u))).to(dtype)
    if spec.init == "rglru_a":  # a-param so sigmoid(.)^8 in ~[0.9, 0.999]
        u = torch.rand(spec.shape, generator=gen, **f32) * (0.999 - 0.9) \
            + 0.9
        lam = u ** (1.0 / 8.0)
        return (torch.log(lam) - torch.log1p(-lam)).to(dtype)
    if spec.init not in ("normal", "embed"):
        raise ValueError(f"unknown initializer {spec.init!r}")
    fan_in = spec.fan_in
    if fan_in is None:
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else spec.shape[-1]
    # GPT-2-style embedding init keeps tied-head logits O(1)
    scale = 0.02 if spec.init == "embed" else 1.0 / math.sqrt(fan_in)
    if len(spec.shape) < 2:
        return (torch.randn(spec.shape, generator=gen, **f32)
                * scale).to(dtype)
    # a matrix is drawn slab by slab along its leading axis, so that a large
    # leaf's float32 draw never stands whole beside the result (Kimi-K2's
    # expert leaf [384, 7168, 2048] would be 22.5 GB of float32); a leaf of
    # at most SLAB_ELEMENTS is one slab, the same draw as a whole one
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    rows = max(1, SLAB_ELEMENTS // max(1, math.prod(spec.shape[1:])))
    for i in range(0, spec.shape[0], rows):
        part = out[i:i + rows]
        part.copy_(torch.randn(part.shape, generator=gen, **f32) * scale)
    return out


def _map_tree(fn, tree):
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return [_map_tree(fn, v) for v in tree]


def init_tree(specs, gen: torch.Generator, dtype, device):
    """Materialize a Spec tree (dicts and lists) into tensors, leaf by leaf
    in the tree's order."""
    return _map_tree(lambda s: init_param(s, gen, dtype, device), specs)


def count_params(specs) -> int:
    if isinstance(specs, Spec):
        return math.prod(specs.shape)
    values = specs.values() if isinstance(specs, dict) else specs
    return sum(count_params(v) for v in values)


def stack_specs(spec, n: int):
    """Prefix every Spec of a tree with a stacking dimension of ``n``
    layers (the JAX layout of a pattern position's layers).  Each stacked
    leaf keeps its one layer's fan-in."""
    def stack(s: Spec) -> Spec:
        fan_in = s.fan_in
        if fan_in is None:
            fan_in = s.shape[0] if len(s.shape) >= 2 else \
                (s.shape[-1] if s.shape else 1)
        return Spec((n,) + tuple(s.shape), s.init, fan_in)
    return _map_tree(stack, spec)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples and NamedTuples in
    JAX's flatten order (dict keys sorted; ``None`` holds no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``), keeping ``tree``'s structure; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(template, leaves):
    """``leaves`` (in JAX's flatten order) in ``template``'s structure."""
    return _fill(template, iter(leaves))


def _fill(t, it):
    # module level, not a closure: a recursive inner function would hold
    # its own cell, and with it the leaves, until the garbage collector ran
    if t is None:
        return None
    if isinstance(t, dict):
        out = {k: _fill(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if _is_namedtuple(t):
        return type(t)(*(_fill(v, it) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_fill(v, it) for v in t)
    return next(it)


def trainable(tree):
    """The trainable form of a parameter tree: every tensor a leaf that
    requires gradients (``Params`` is the frozen serving form)."""
    return tree_map(lambda x: x.detach().requires_grad_(True), tree)


class Params(nn.Module):
    """A parameter tree as a module: dicts become ``Params``, lists
    ``nn.ModuleList``s and tensors frozen ``nn.Parameter``s (serving takes
    no gradients; ``trainable`` is the training form).  ``p[name]`` and
    ``name in p`` read it like a dict."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Params(value))
            elif isinstance(value, list):
                self.add_module(name, nn.ModuleList(Params(v)
                                                    for v in value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# --------------------------------------------------------------------- layers
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation (bf16-safe)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * gamma.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    # a Python-scalar base: no host-to-device copy (and its stream sync)
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / torch.pow(theta, exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-halves rope.  x: [..., S, H, D]; positions: [S]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # [D/2]
    angles = positions[..., None].float() * freqs              # [S, D/2]
    cos = torch.cos(angles)[..., None, :]                      # [S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time as W shifted multiply-adds in x's
    dtype (the reference's order; ``F.conv1d`` would sum differently).
    x: [B, S, C]; w: [W, C]; b: [C]."""
    W = w.shape[0]
    out = x * w[W - 1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[W - 1 - i]
    return out + b


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
