"""Persistence-path control in PyTorch, on an NVIDIA H100.

The port of the JAX package ``repro`` (which stays the reference), with the
same layer layout: ``core`` (types, counter RNG, engine, block driver),
``kernels`` (the fused persistence-path RMW as a hand-written CUDA kernel
plus its plain PyTorch version) and ``streaming`` (workload generators,
the byte-backed KV stores and the write-behind sink).  It imports neither
``jax`` nor ``repro``.  Entry points run on ``cuda:0`` unless the caller
passes ``device="cpu"``.
"""
