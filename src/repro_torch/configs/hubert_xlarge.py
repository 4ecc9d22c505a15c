"""hubert-xlarge — 48L d=1280 16H kv=16 d_ff=5120 v=504 encoder-only
(arXiv:2106.07447).  Conv waveform frontend is a STUB: input_specs supplies
precomputed frame embeddings [B, S, 512]."""
from repro_torch.configs.base import ModelConfig, RunConfig


def get_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name='hubert-xlarge',
            family='audio',
            num_layers=48,
            d_model=1280,
            num_heads=16,
            num_kv_heads=16,
            head_dim=80,
            d_ff=5120,
            vocab_size=504,
            causal=False,
            mlp_gated=False,
            input_mode='frames',
            frame_dim=512,
        ),
    )


def get_smoke_config() -> RunConfig:
    """Reduced same-family config for CPU smoke tests."""
    return RunConfig(
        model=ModelConfig(
            name='hubert-smoke',
            family='audio',
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=4,
            head_dim=16,
            d_ff=192,
            vocab_size=32,
            causal=False,
            mlp_gated=False,
            input_mode='frames',
            frame_dim=24,
        ),
    )
