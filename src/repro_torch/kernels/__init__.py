"""The port's three kernels: CUDA sources' bindings, plain versions,
wrappers."""
