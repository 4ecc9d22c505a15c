"""The fused persistence-path RMW: CUDA kernel, plain version, wrapper."""
