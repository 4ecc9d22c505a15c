"""mamba2-2.7b — 64L d=2560 SSD, state=128 (arXiv:2405.21060)."""
from repro_torch.configs.base import ModelConfig, RunConfig


def get_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name='mamba2-2.7b',
            family='ssm',
            num_layers=64,
            d_model=2560,
            num_heads=80,
            num_kv_heads=80,
            head_dim=64,
            d_ff=0,
            vocab_size=50280,
            ssm_state=128,
            ssm_expand=2,
            ssm_head_dim=64,
            ssm_chunk=256,
            ssm_conv_width=4,
            ssm_groups=1,
        ),
    )


def get_smoke_config() -> RunConfig:
    """Reduced same-family config for CPU smoke tests."""
    return RunConfig(
        model=ModelConfig(
            name='mamba2-smoke',
            family='ssm',
            num_layers=2,
            d_model=64,
            num_heads=2,
            num_kv_heads=2,
            head_dim=64,
            d_ff=0,
            vocab_size=257,
            ssm_state=16,
            ssm_expand=2,
            ssm_head_dim=64,
            ssm_chunk=8,
            ssm_conv_width=4,
            ssm_groups=1,
        ),
    )
