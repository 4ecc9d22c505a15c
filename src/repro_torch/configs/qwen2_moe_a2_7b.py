"""qwen2-moe-a2.7b — 24L d=2048 16H kv=16, 60 routed top-4 + 4 shared,
moe_d_ff=1408, v=151936 (hf Qwen1.5-MoE-A2.7B).  60 experts padded to 64
for EP divisibility (pads masked out of routing)."""
from repro_torch.configs.base import ModelConfig, RunConfig, TrainConfig


def get_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name='qwen2-moe-a2.7b',
            family='moe',
            num_layers=24,
            d_model=2048,
            num_heads=16,
            num_kv_heads=16,
            head_dim=128,
            d_ff=5632,
            vocab_size=151936,
            num_experts=60,
            num_experts_padded=64,
            top_k=4,
            num_shared_experts=4,
            moe_d_ff=1408,
            rope_theta=1000000.0,
        ),
        train=TrainConfig(grad_accum=2),
    )


def get_smoke_config() -> RunConfig:
    """Reduced same-family config for CPU smoke tests."""
    return RunConfig(
        model=ModelConfig(
            name='qwen2-moe-smoke',
            family='moe',
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=4,
            head_dim=16,
            d_ff=128,
            vocab_size=128,
            num_experts=6,
            num_experts_padded=8,
            top_k=2,
            num_shared_experts=2,
            moe_d_ff=32,
        ),
        train=TrainConfig(),
    )
