"""smollm-360m — 32L d=960 15H GQA kv=5 d_ff=2560 v=49152 (hf SmolLM)."""
from repro_torch.configs.base import ModelConfig, RunConfig


def get_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name='smollm-360m',
            family='dense',
            num_layers=32,
            d_model=960,
            num_heads=15,
            num_kv_heads=5,
            head_dim=64,
            d_ff=2560,
            vocab_size=49152,
            tie_embeddings=True,
        ),
    )


def get_smoke_config() -> RunConfig:
    """Reduced same-family config for CPU smoke tests."""
    return RunConfig(
        model=ModelConfig(
            name='smollm-smoke',
            family='dense',
            num_layers=2,
            d_model=60,
            num_heads=3,
            num_kv_heads=1,
            head_dim=20,
            d_ff=160,
            vocab_size=128,
            tie_embeddings=True,
        ),
    )
