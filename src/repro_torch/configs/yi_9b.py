"""yi-9b — llama-arch 48L d=4096 32H GQA kv=4 d_ff=11008 v=64000 (arXiv:2403.04652)."""
from repro_torch.configs.base import ModelConfig, RunConfig, TrainConfig


def get_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name='yi-9b',
            family='dense',
            num_layers=48,
            d_model=4096,
            num_heads=32,
            num_kv_heads=4,
            head_dim=128,
            d_ff=11008,
            vocab_size=64000,
            rope_theta=5000000.0,
        ),
        train=TrainConfig(grad_accum=4),
    )


def get_smoke_config() -> RunConfig:
    """Reduced same-family config for CPU smoke tests."""
    return RunConfig(
        model=ModelConfig(
            name='yi-smoke',
            family='dense',
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            d_ff=160,
            vocab_size=128,
        ),
        train=TrainConfig(),
    )
