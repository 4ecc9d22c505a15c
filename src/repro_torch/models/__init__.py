"""The model stack of the dense, SSM, audio and hybrid families: common
machinery, the MLPs, the attention, SSD and RG-LRU blocks, the backbone
and the JAX weight carry-over."""
