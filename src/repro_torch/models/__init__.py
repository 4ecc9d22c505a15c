"""The hybrid (RecurrentGemma) model stack: common machinery, the MLP,
the RG-LRU and local-attention blocks, the backbone and the JAX weight
carry-over."""
