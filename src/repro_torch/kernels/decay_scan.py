"""CUDA ``decay_scan``: bind and launch ``csrc/decay_scan.cu``.

The kernel replaces the Pallas TPU kernel of ``repro.kernels.decay_scan``
(the note at the top of the CUDA source gives its numerics, design and
bound): ``h[t] = a[t] * h[t-1] + u[t]`` over ``[T, C]`` float32, bitwise
equal to the plain loop ``ref.decay_scan_ref``; and its backward
``decay_scan_bwd`` (the same source), bitwise equal to
``ref.decay_scan_bwd_ref``.  ``KERNEL`` builds both with ``nvcc`` at first
use; nothing is built or loaded at import.

``launches`` counts forward launches made through ``decay_scan_cuda``,
``bwd_launches`` backward launches made through ``decay_scan_bwd_cuda``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel

launches = 0            # forward launches since the last reset
bwd_launches = 0        # backward launches since the last reset


def _bind(lib) -> None:
    fn = lib.decay_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    fn = lib.decay_scan_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]


KERNEL = CudaKernel("decay_scan", ("-fmad=false",), _bind)


def check_args(a, u, h0) -> None:
    """Raise unless ``a``, ``u`` are float32 ``[T, C]`` and ``h0`` is None
    or float32 ``[C]``, all on one device."""
    named = [("a", a), ("u", u)] + ([("h0", h0)] if h0 is not None else [])
    for name, x in named:
        if x.dtype != torch.float32:
            raise ValueError(f"decay_scan: {name} must be float32, got "
                             f"{x.dtype}")
        if x.device != a.device:
            raise ValueError(f"decay_scan: {name} is on {x.device}, a on "
                             f"{a.device}")
    if a.dim() != 2 or u.shape != a.shape:
        raise ValueError(f"decay_scan: a and u must be [T, C] of one shape, "
                         f"got {tuple(a.shape)} and {tuple(u.shape)}")
    if h0 is not None and tuple(h0.shape) != (a.shape[1],):
        raise ValueError(f"decay_scan: h0 must be [{a.shape[1]}], got "
                         f"{tuple(h0.shape)}")


def decay_scan_cuda(a, u, h0=None):
    """Launch the kernel on contiguous CUDA tensors; returns ``h [T, C]``."""
    global launches
    check_args(a, u, h0)
    if a.device.type != "cuda":
        raise ValueError(f"decay_scan_cuda takes CUDA tensors, got "
                         f"{a.device}")
    for name, x in (("a", a), ("u", u), ("h0", h0)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"decay_scan_cuda: {name} must be contiguous")
    T, C = a.shape
    out = torch.empty_like(a)
    if T and C:
        fn = KERNEL.lib().decay_scan_launch
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = fn(ctypes.c_void_p(a.data_ptr()),
                     ctypes.c_void_p(u.data_ptr()),
                     ctypes.c_void_p(h0.data_ptr() if h0 is not None else 0),
                     ctypes.c_void_p(out.data_ptr()), T, C,
                     ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"decay_scan launch failed: CUDA error {err}")
        launches += 1
    return out


def decay_scan_bwd_cuda(a, h, g, h0=None):
    """The backward kernel on contiguous float32 CUDA tensors: a, h (the
    forward's states), g (the gradient of h) [T, C]; h0 [C] or None.
    Returns ``(da, du, dh0)`` (``dh0`` None without ``h0``)."""
    global bwd_launches
    check_args(a, g, h0)
    if h.shape != a.shape or h.dtype != a.dtype or h.device != a.device:
        raise ValueError(f"decay_scan_bwd: h must be float32 "
                         f"{tuple(a.shape)} on {a.device}")
    if a.device.type != "cuda":
        raise ValueError(f"decay_scan_bwd_cuda takes CUDA tensors, got "
                         f"{a.device}")
    for name, x in (("a", a), ("h", h), ("g", g), ("h0", h0)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"decay_scan_bwd_cuda: {name} must be "
                             f"contiguous")
    T, C = a.shape
    du = torch.empty_like(a)
    da = torch.empty_like(a)
    dh0 = torch.zeros_like(h0) if h0 is not None else None
    if T and C:
        fn = KERNEL.lib().decay_scan_bwd_launch
        ptr = lambda x: ctypes.c_void_p(x.data_ptr() if x is not None else 0)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = fn(ptr(a), ptr(g), ptr(h), ptr(h0), ptr(du), ptr(da),
                     ptr(dh0), T, C, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"decay_scan_bwd launch failed: CUDA error "
                               f"{err}")
        bwd_launches += 1
    return da, du, dh0
