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

from repro_torch.distributed import collectives
from repro_torch.distributed import context as dctx


class Spec(NamedTuple):
    """Parameter descriptor: shape + logical axes + initializer.  The
    axes name each dim for the sharding rules (``distributed.sharding``);
    None leaves a dim to replicate (no axes at all: every dim)."""

    shape: tuple
    axes: Optional[tuple] = None   # logical axis name (or None) per dim
    init: str = "normal"   # normal | zeros | ones | embed | ssm_a | ssm_dt
    #                        | rglru_a
    fan_in: Optional[int] = None

    def logical_axes(self) -> tuple:
        return self.axes if self.axes is not None else \
            (None,) * len(self.shape)

    def pspec(self) -> tuple:
        """Each dim's mesh-axis entry under the installed mesh and rules
        (``distributed.context.pspec_for``)."""
        return dctx.pspec_for(self.shape, self.logical_axes())


def is_spec(x) -> bool:
    return isinstance(x, Spec)


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


def map_specs(fn, tree):
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return [map_specs(fn, v) for v in tree]


def init_tree(specs, gen: torch.Generator, dtype, device):
    """Materialize a Spec tree (dicts and lists) into tensors, leaf by leaf
    in the tree's order."""
    return map_specs(lambda s: init_param(s, gen, dtype, device), specs)


def count_params(specs) -> int:
    if isinstance(specs, Spec):
        return math.prod(specs.shape)
    values = specs.values() if isinstance(specs, dict) else specs
    return sum(count_params(v) for v in values)


def pspec_tree(specs):
    """Each leaf's mesh-axis entries (``Spec.pspec``), in the tree's
    structure."""
    return map_specs(Spec.pspec, specs)


def stack_specs(spec, n: int, axis_name: Optional[str] = "layers"):
    """Prefix every Spec of a tree with a stacking dimension of ``n``
    layers (the JAX layout of a pattern position's layers), named
    ``axis_name``.  Each stacked leaf keeps its one layer's fan-in."""
    def stack(s: Spec) -> Spec:
        fan_in = s.fan_in
        if fan_in is None:
            fan_in = s.shape[0] if len(s.shape) >= 2 else \
                (s.shape[-1] if s.shape else 1)
        return Spec((n,) + tuple(s.shape), (axis_name,) + s.logical_axes(),
                    s.init, fan_in)
    return map_specs(stack, spec)


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


def tree_leaves_specs(specs) -> list:
    """The Specs of a spec tree in JAX's flatten order (dict keys
    sorted), as ``tree_leaves`` walks the tree it describes."""
    if isinstance(specs, Spec):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in tree_leaves_specs(specs[k])]
    return [x for v in specs for x in tree_leaves_specs(v)]


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


def shard(x, *axes):
    return dctx.shard(x, *axes)


# ------------------------------------------------ tensor-parallel regions
# Under a tensor-parallel context (``distributed.context.tp_context``) a
# block runs *local* (each rank on its shard of the heads or channels the
# rules split over "model", with Megatron's collectives around it) or
# *whole* (every rank the same compute on whole weights).  The residual
# stream between blocks is replicated, or under ``seq_parallel`` split by
# rows; ``region_in`` / ``region_out`` take it into and out of a block.
# Every parameter's gradient then ends up complete on each rank that holds
# it: a local shard's from its own compute, a replicated parameter's the
# same on every rank (``region_param`` sums it where rank-local compute
# or the rank's rows use it).
#
# The split products sum in another order than one process's whole ones,
# so the two round differently: no bitwise result is expected.


_LOW = (torch.bfloat16, torch.float16)


def region_in(x: torch.Tensor, local: bool) -> torch.Tensor:
    """The block's input from the residual stream.  A local block's
    products take it as it is (``col_matmul`` applies Megatron's f, or
    under sequence parallelism the rows' gather, to each product); a
    whole block's input has its rows gathered under sequence parallelism
    (the gradient this rank's rows)."""
    g = dctx.model_group()
    if g is None or local or not dctx.sp_active():
        return x
    return collectives.gather_model(x, g, 1)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] of low-precision inputs, accumulated and
    returned in float32 (not rounded): cuBLAS's bf16 product with a
    float32 output on the card; the CPU, which has no such product, takes
    the inputs to float32 (exact) first."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _ColProduct(torch.autograd.Function):
    """A column-parallel product x @ w of a local block: Megatron's f
    (identity; the input's gradient summed over the ranks) or, under
    sequence parallelism, the rows gathered (the gradient
    reduce-scattered).  Each product sums its own input gradient, its
    ranks' partial sums in float32 before the one rounding that one
    process's whole product makes; autograd then adds the block's
    products' gradients in the input's dtype as it does in one process."""

    @staticmethod
    def forward(ctx, x, w, group, sp):
        if sp:
            x = collectives.all_gather_model(x, group, 1)
        ctx.save_for_backward(x, w)
        ctx.group, ctx.sp = group, sp
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = (_mm_f32(g2, w.t()) if g.dtype in _LOW else g2 @ w.t()
              ).reshape(x.shape)
        dx = collectives.reduce_scatter_model(dx, ctx.group, 1) if ctx.sp \
            else collectives.all_reduce_model(dx, ctx.group)
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(), g2)
        return dx.to(x.dtype), dw, None, None


def col_matmul(x: torch.Tensor, w: torch.Tensor, local: bool = False,
               sp: Optional[bool] = None) -> torch.Tensor:
    """``x @ w`` for a block's input ``x`` (``region_in``): where the
    block is local under a tensor-parallel context, ``_ColProduct`` (``sp``:
    whether ``x`` holds the rank's rows, default the context's)."""
    g = dctx.model_group()
    if not local or g is None:
        return torch.matmul(x, w)
    return _ColProduct.apply(x, w, g, dctx.sp_active() if sp is None
                             else sp)


class _RowMatmul(torch.autograd.Function):
    """x [..., K] @ w [K, N] with a float32 result from low-precision
    inputs (the products accumulated in float32 and not rounded): the
    ranks' partial sums of a row-parallel product are summed before the
    one rounding that one process's whole product makes.  The backward
    is the plain product's, in the inputs' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = _mm_f32(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(x.shape[:-1] + w.shape[1:])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = torch.matmul(g, w.t())
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                          g.reshape(-1, g.shape[-1]))
        return dx, dw


def row_matmul(x: torch.Tensor, w: torch.Tensor, local: bool
               ) -> torch.Tensor:
    """``x @ w`` for a product whose contraction dim may be split over
    "model" (``local``): there, from bfloat16 inputs, a float32 partial
    sum that ``region_out`` sums and rounds to ``x``'s dtype once."""
    if local and dctx.model_group() is not None and x.dtype in _LOW:
        return _RowMatmul.apply(x, w)
    return torch.matmul(x, w)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The batched ``_mm_f32``: a [E, M, K] @ b [E, K, N] accumulated and
    returned in float32."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _RowBmm(torch.autograd.Function):
    """``_RowMatmul`` batched over experts: x [E, C, K] @ w [E, K, N] with
    a float32 result from low-precision inputs; the backward is the plain
    products', in the inputs' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _bmm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return torch.bmm(g, w.transpose(1, 2)), \
            torch.bmm(x.transpose(1, 2), g)


def row_bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(x, w)`` whose contraction dim is the rank's split of
    "model": from bfloat16 inputs a float32 partial sum, which the
    caller's ``region_out`` sums and rounds once."""
    if dctx.model_group() is not None and x.dtype in _LOW:
        return _RowBmm.apply(x, w)
    return torch.bmm(x, w)


def region_out(out: torch.Tensor, local: bool,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The block's output back to the residual stream: the ranks' partial
    sums of a local block summed (under sequence parallelism
    reduce-scattered by rows); a whole block's output as it is (its
    rows scattered).  The sum rounds to ``dtype`` (a float32 partial
    sum of ``row_matmul``)."""
    g = dctx.model_group()
    if g is not None:
        if dctx.sp_active():
            out = collectives.reduce_scatter_to_model(out, g, 1) if local \
                else collectives.scatter_model(out, g, 1)
        elif local:
            out = collectives.reduce_from_model(out, g)
    return out if dtype is None else out.to(dtype)


def region_param(w: torch.Tensor) -> torch.Tensor:
    """A replicated parameter used by rank-local compute: its gradient
    summed over "model"."""
    g = dctx.model_group()
    return w if g is None else collectives.copy_to_model(w, g)


def row_param(w: torch.Tensor) -> torch.Tensor:
    """A replicated parameter applied to the residual stream's rows (a
    norm's scale, an output bias, a gate): under sequence parallelism
    each rank holds some rows, so its gradient is summed over "model"."""
    return region_param(w) if dctx.sp_active() else w


def whole_param(w: torch.Tensor, logical: Optional[str], dim: int,
                size: int) -> torch.Tensor:
    """A parameter that rank-local compute uses whole (a head_dim norm,
    Mamba-2's conv over mixed channels): gathered where the rules split
    its ``dim`` of ``size`` (``logical``), the gradient summed either way."""
    g = dctx.model_group()
    if g is None:
        return w
    if dctx.is_local(logical, size):
        return collectives.gather_model(w, g, dim, sum_grad=True)
    return collectives.copy_to_model(w, g)


def whole_rows(x: torch.Tensor) -> torch.Tensor:
    """The residual stream with all its rows (gathered under sequence
    parallelism; the gradient this rank's rows)."""
    g = dctx.model_group()
    if g is None or not dctx.sp_active():
        return x
    return collectives.gather_model(x, g, 1)


def sharded_rms_norm(x: torch.Tensor, gamma: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` over a last dim split over "model" (``x`` and
    ``gamma`` the rank's channels): the sum of squares summed over the
    ranks."""
    g = dctx.model_group()
    if g is None:
        return rms_norm(x, gamma, eps)
    xf = x.float()
    n = xf.shape[-1] * dctx.model_size()
    ss = collectives.sum_in_region(torch.sum(xf * xf, dim=-1, keepdim=True),
                                   g)
    y = xf * torch.rsqrt(ss / n + eps)
    return (y * gamma.float()).to(x.dtype)
