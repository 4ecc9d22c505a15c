"""The model stack of every family: common machinery, the MLPs and the
mixture of experts (dense and expert-parallel), the attention (self and
cross), SSD and RG-LRU blocks, the backbone and the JAX weight
carry-over."""
