"""CUDA ``flash_attention``: bind and launch ``csrc/flash_attention.cu``.

The kernel replaces the Pallas TPU kernel of
``repro.kernels.flash_attention`` (the note at the top of the CUDA source
gives its semantics, design and bound): online-softmax GQA attention with
causal and local-window masks and a tanh softcap, on float32 or bfloat16
``q [B, H, Sq, D]``, ``k``/``v [B, Kh, Skv, D]``.  bfloat16 runs both
products on the tensor cores (``wgmma``, TMA-fed); float32 stays on scalar
FMAs, since a tensor-core float32 product would be TF32.  ``KERNEL`` builds
it with ``nvcc`` at first use; nothing is built or loaded at import.

``launches`` counts kernel launches made through ``flash_attention_cuda``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._build import CudaKernel

launches = 0            # kernel launches since the last reset

MAX_HEAD_DIM = 256      # the widest O accumulator either path holds
DTYPES = (torch.float32, torch.bfloat16)   # index = the kernel's dtype code


def _bind(lib) -> None:
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p])


KERNEL = CudaKernel("flash_attention", (), _bind)


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


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0):
    """Launch the kernel on contiguous CUDA tensors; returns [B,H,Sq,D]."""
    global launches
    check_args(q, k, v, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes CUDA tensors, got "
                         f"{q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             f"contiguous")
    B, H, Sq, D = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B and H and Sq:
        if B * H > 65535:
            raise ValueError(f"flash_attention_cuda: B*H = {B * H} exceeds "
                             f"the grid's y limit")
        fn = KERNEL.lib().flash_attention_launch
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(*(ctypes.c_void_p(x.data_ptr()) for x in (q, k, v, out)),
                     DTYPES.index(q.dtype), B, H, Kh, Sq, Skv, D,
                     float(np.float32(D ** -0.5)), int(bool(causal)),
                     int(window), float(np.float32(softcap)),
                     ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"flash_attention launch failed: CUDA error "
                               f"{err}")
        launches += 1
    return out
