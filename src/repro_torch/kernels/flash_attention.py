"""CUDA ``flash_attention``: bind and launch ``csrc/flash_attention.cu``.

The kernel replaces the Pallas TPU kernel of
``repro.kernels.flash_attention`` (the note at the top of the CUDA source
gives its semantics, design and bound): online-softmax GQA attention with
causal and local-window masks and a tanh softcap, on float32 or bfloat16
``q [B, H, Sq, D]``, ``k``/``v [B, Kh, Skv, D]``.  bfloat16 runs both
products on the tensor cores (``wgmma``, TMA-fed); float32 stays on scalar
FMAs, since a tensor-core float32 product would be TF32.  Asked for
(``return_lse=True``), the same launch also writes each row's
log-sum-exp, which the backward reads.  The backward,
``flash_attention_bwd_cuda``, launches ``csrc/flash_attention_bwd.cu``
(its note gives the design and bound): Delta, dK/dV, for bfloat16 the
reduction of a split query-head group, then dQ, all for one call.
``KERNEL`` and ``BWD_KERNEL`` build them with ``nvcc`` at first use;
nothing is built or loaded at import.

``launches`` counts forward launches made through ``flash_attention_cuda``,
``bwd_launches`` backward calls made through ``flash_attention_bwd_cuda``
(one call launches three or four kernels: the reduction of a split group
is part of the call).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._build import CudaKernel

launches = 0            # forward launches since the last reset
bwd_launches = 0        # backward calls since the reset

MAX_HEAD_DIM = 256      # the widest O accumulator either path holds
DTYPES = (torch.float32, torch.bfloat16)   # index = the kernel's dtype code


def _bind(lib) -> None:
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p])


def _bind_bwd(lib) -> None:
    fn = lib.flash_attention_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn = lib.flash_attention_bwd_splits
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6


KERNEL = CudaKernel("flash_attention", (), _bind)
BWD_KERNEL = CudaKernel("flash_attention_bwd", (), _bind_bwd)


def check_args(q, k, v, *, window: int, softcap: float) -> None:
    """Raise unless q [B,H,Sq,D] and k, v [B,Kh,Skv,D] share one dtype
    (float32 or bfloat16) and one device, with H a multiple of Kh,
    Skv >= 1 and 1 <= D <= 256."""
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention: {name} is {x.dtype} on "
                             f"{x.device}, q {q.dtype} on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be [B,H,Sq,D] and k, v "
                         f"[B,Kh,Skv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] < 1 \
            or H % k.shape[1]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if k.shape[2] < 1:
        raise ValueError("flash_attention: k and v hold no keys")
    if window < 0 or softcap < 0:
        raise ValueError("flash_attention: window and softcap must be >= 0")


def _require_cuda(name, tensors) -> None:
    for tname, x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"{name} takes CUDA tensors, got {tname} on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def _scalars(q, k, causal, window, softcap):
    B, H, Sq, D = q.shape
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H = {B * H} exceeds the "
                         f"grid's y limit")
    return (B, H, k.shape[1], Sq, k.shape[2], D,
            float(np.float32(D ** -0.5)), int(bool(causal)), int(window),
            float(np.float32(softcap)))


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, return_lse: bool = False):
    """Launch the kernel on contiguous CUDA tensors; returns [B,H,Sq,D]
    (and, with ``return_lse``, the rows' log-sum-exp [B,H,Sq] float32)."""
    global launches
    check_args(q, k, v, window=window, softcap=softcap)
    _require_cuda("flash_attention_cuda", (("q", q), ("k", k), ("v", v)))
    B, H, Sq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if B and H and Sq:
        fn = KERNEL.lib().flash_attention_launch
        B, H, Kh, Sq, Skv, D, scale, c, w, cap = _scalars(q, k, causal,
                                                          window, softcap)
        with torch.cuda.device(q.device):
            err = fn(*(ctypes.c_void_p(x.data_ptr()) for x in (q, k, v, out)),
                     ctypes.c_void_p(lse.data_ptr() if return_lse else 0),
                     DTYPES.index(q.dtype), B, H, Kh, Sq, Skv, D, scale, c,
                     w, cap, _stream(q.device))
        if err != 0:
            raise RuntimeError(f"flash_attention launch failed: CUDA error "
                               f"{err}")
        launches += 1
    return (out, lse) if return_lse else out


def bwd_splits(q, k) -> int:
    """How many blocks split each KV head's query-head group in the
    backward's dK/dV kernel for q [B,H,Sq,D], k [B,Kh,Skv,D] on their card
    (1 for float32, or where the grid is already long)."""
    B, H, _, D = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        return BWD_KERNEL.lib().flash_attention_bwd_splits(
            DTYPES.index(q.dtype), B, H, Kh, Skv, D)


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """The backward kernels on contiguous CUDA tensors: q, k, v and the
    forward's output ``o`` and ``lse``, the gradient ``do`` of ``o``.
    Returns (dq, dk, dv) in the inputs' dtype."""
    global bwd_launches
    check_args(q, k, v, window=window, softcap=softcap)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"{q.dtype} {tuple(q.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"flash_attention_bwd: lse must be float32 "
                         f"{tuple(q.shape[:3])}")
    _require_cuda("flash_attention_bwd_cuda",
                  (("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse),
                   ("do", do)))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    B, H, Sq, _ = q.shape
    if not (B and H and Sq):
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    B, H, Kh, Sq, Skv, D, scale, c, w, cap = _scalars(q, k, causal, window,
                                                      softcap)
    dtype = DTYPES.index(q.dtype)
    splits = bwd_splits(q, k)
    ws = torch.empty(2 * splits * B * Kh * Skv * D, dtype=torch.float32,
                     device=q.device) if splits > 1 else None
    with torch.cuda.device(q.device):
        err = BWD_KERNEL.lib().flash_attention_bwd_launch(
            *(ctypes.c_void_p(x.data_ptr())
              for x in (q, k, v, o, do, lse, delta, dq, dk, dv)),
            ctypes.c_void_p(ws.data_ptr() if ws is not None else 0),
            dtype, B, H, Kh, Sq, Skv, D, scale, c, w, cap, splits,
            _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    bwd_launches += 1
    return dq, dk, dv
