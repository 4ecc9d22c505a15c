"""Architecture / run configuration schema and registry (PyTorch port).

A copy of ``repro.configs.base`` (plain Python, copied so that the port
imports nothing of ``repro``): ``ModelConfig`` keeps the JAX names and
defaults of the fields the serving and training paths read (the JAX
package's ``q_chunk`` / ``kv_chunk`` tile its jnp attention and have no
use here), ``TrainConfig`` is the JAX one field for field, and
``RunConfig`` holds both.  The registry lists the JAX package's ten
architectures in its order.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
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
    # MoE
    num_experts: int = 0
    num_experts_padded: int = 0    # >= num_experts, divisible by the EP size
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0    # the layer plan's prefix of attn layers
    capacity_factor: float = 1.25
    moe_impl: str = "spmd"         # spmd (dense ffn.moe) | ep_a2a (moe_ep)
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
    # vlm
    cross_attn_every: int = 0      # a cross-attn layer every k layers
    num_vision_tokens: int = 0
    # audio / frame-input
    input_mode: str = "tokens"     # tokens | frames
    frame_dim: int = 0
    scale_embeddings: bool = False # gemma-style sqrt(d_model) embed scaling
    mlp_gated: bool = True         # SwiGLU (True) vs GELU MLP (False)

    def validate(self):
        """The JAX ``validate``'s checks, raising ``ValueError``."""
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: {self.num_heads} heads are not "
                             f"a multiple of {self.num_kv_heads} KV heads")
        if self.family == "moe" and not (
                self.num_experts > 0 and self.top_k > 0
                and self.num_experts_padded >= self.num_experts):
            raise ValueError(f"{self.name}: a MoE needs experts, top_k > 0 "
                             f"and num_experts_padded >= num_experts")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"       # adamw | adafactor
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    master_weights: bool = True    # fp32 master copies (adamw only)
    grad_accum: int = 1            # microbatch count per step
    remat: bool = True
    moe_aux_weight: float = 0.01
    moe_z_weight: float = 1e-3
    label_smoothing: float = 0.0   # read by neither package's loss
    # beyond-paper: HT-thinned gradient sync (train/compression.py)
    thinned_sync: bool = False
    thinned_sync_budget: float = 0.25
    thinned_sync_alpha: float = 2.0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


ARCH_IDS = [
    "mamba2-2.7b", "command-r-plus-104b", "yi-9b", "smollm-360m", "qwen3-4b",
    "kimi-k2-1t-a32b", "qwen2-moe-a2.7b", "llama-3.2-vision-90b",
    "recurrentgemma-2b", "hubert-xlarge",
]
DEFAULT_ARCH = "recurrentgemma-2b"


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}; repro_torch "
                         f"serves {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def load_config(arch_id: str) -> RunConfig:
    return _module(arch_id).get_config()


def load_smoke_config(arch_id: str) -> RunConfig:
    return _module(arch_id).get_smoke_config()
