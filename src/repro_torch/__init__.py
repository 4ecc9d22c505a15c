"""Persistence-path control in PyTorch, on an NVIDIA H100.

The port of the JAX package ``repro`` (which stays the reference), with the
same layer layout: ``core`` (types, counter RNG, engine, block driver
with bounded residency and the pipelined plane, the per-event oracle),
``kernels`` (hand-written CUDA kernels plus their plain PyTorch versions),
``streaming`` (workload generators, the byte-backed KV stores and their
fault injection, the resident set, the write-behind sink, the per-event
worker and its replay drivers), ``features`` and ``distributed`` (the
feature engine on one card and its layouts), ``serving`` (the scoring
pipeline and its open-loop frontend, LM serving steps), ``checkpoint``
(state save and restore) and the model stack (``configs``, ``models``,
``launch``).  It imports neither
``jax`` nor ``repro``.  Entry points run on ``cuda:0`` unless the caller
passes ``device="cpu"``.
"""
