"""command-r-plus-104b — 64L d=12288 96H GQA kv=8 d_ff=33792 v=256000."""
from repro_torch.configs.base import ModelConfig, RunConfig, TrainConfig


def get_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name='command-r-plus-104b',
            family='dense',
            num_layers=64,
            d_model=12288,
            num_heads=96,
            num_kv_heads=8,
            head_dim=128,
            d_ff=33792,
            vocab_size=256000,
            use_bias=False,
            rope_theta=75000000.0,
        ),
        train=TrainConfig(grad_accum=16),
    )


def get_smoke_config() -> RunConfig:
    """Reduced same-family config for CPU smoke tests."""
    return RunConfig(
        model=ModelConfig(
            name='command-r-smoke',
            family='dense',
            num_layers=2,
            d_model=96,
            num_heads=6,
            num_kv_heads=2,
            head_dim=16,
            d_ff=256,
            vocab_size=271,
            rope_theta=10000.0,
        ),
        train=TrainConfig(),
    )
