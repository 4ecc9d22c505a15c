"""qwen3-4b — 36L d=2560 32H GQA kv=8 d_ff=9728 v=151936, qk-norm."""
from repro_torch.configs.base import ModelConfig, RunConfig, TrainConfig


def get_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name='qwen3-4b',
            family='dense',
            num_layers=36,
            d_model=2560,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            d_ff=9728,
            vocab_size=151936,
            qk_norm=True,
            rope_theta=1000000.0,
        ),
        train=TrainConfig(grad_accum=2),
    )


def get_smoke_config() -> RunConfig:
    """Reduced same-family config for CPU smoke tests."""
    return RunConfig(
        model=ModelConfig(
            name='qwen3-smoke',
            family='dense',
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            d_ff=192,
            vocab_size=128,
            qk_norm=True,
        ),
        train=TrainConfig(),
    )
