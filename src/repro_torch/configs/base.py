"""Architecture / run configuration schema and registry (PyTorch port).

A copy of ``repro.configs.base`` (plain Python, copied so that the port
imports nothing of ``repro``), cut to what the serving path of the dense,
SSM, audio and hybrid families reads: ``ModelConfig`` keeps the JAX names
and defaults of those fields, and ``RunConfig`` holds the model alone (the
training settings come back with the training code).  The registry lists
the architectures the port serves, in the JAX package's order; the MoE
and vision architectures of the JAX package are not ported yet and
``load_config`` refuses them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | ssm | hybrid | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # dense-transformer flags
    qk_norm: bool = False
    use_bias: bool = False
    tie_embeddings: bool = False
    causal: bool = True            # False => encoder-only (no decode path)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    attn_window: int = 0           # 0 = global attention
    attn_softcap: float = 0.0
    first_dense_layers: int = 0    # the layer plan's prefix of attn layers
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_groups: int = 1
    # hybrid (recurrentgemma): repeating block pattern
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    rglru_conv_width: int = 4
    rglru_expand: int = 1          # lru width = expand * d_model (RG uses 1)
    # audio / frame-input
    input_mode: str = "tokens"     # tokens | frames
    frame_dim: int = 0
    scale_embeddings: bool = False # gemma-style sqrt(d_model) embed scaling
    mlp_gated: bool = True         # SwiGLU (True) vs GELU MLP (False)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig


ARCH_IDS = [
    "mamba2-2.7b", "command-r-plus-104b", "yi-9b", "smollm-360m", "qwen3-4b",
    "recurrentgemma-2b", "hubert-xlarge",
]
DEFAULT_ARCH = "recurrentgemma-2b"


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"repro_torch serves only {ARCH_IDS}; {arch_id!r} "
                         f"is not ported yet")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def load_config(arch_id: str) -> RunConfig:
    return _module(arch_id).get_config()


def load_smoke_config(arch_id: str) -> RunConfig:
    return _module(arch_id).get_smoke_config()
