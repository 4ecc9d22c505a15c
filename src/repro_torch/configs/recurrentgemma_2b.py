"""recurrentgemma-2b — 26L d=2560 10H MQA kv=1 d_ff=7680 v=256000;
RG-LRU + local attention (window 2048), 1:2 pattern (arXiv:2402.19427)."""
from repro_torch.configs.base import ModelConfig, RunConfig


def get_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name='recurrentgemma-2b',
            family='hybrid',
            num_layers=26,
            d_model=2560,
            num_heads=10,
            num_kv_heads=1,
            head_dim=256,
            d_ff=7680,
            vocab_size=256000,
            attn_window=2048,
            block_pattern=('rec', 'rec', 'attn'),
            rglru_conv_width=4,
            rglru_expand=1,
            tie_embeddings=True,
            scale_embeddings=True,
            attn_softcap=0.0,
        ),
    )


def get_smoke_config() -> RunConfig:
    """Reduced same-family config for CPU smoke tests."""
    return RunConfig(
        model=ModelConfig(
            name='rg-smoke',
            family='hybrid',
            num_layers=5,
            d_model=64,
            num_heads=4,
            num_kv_heads=1,
            head_dim=16,
            d_ff=192,
            vocab_size=128,
            attn_window=16,
            block_pattern=('rec', 'rec', 'attn'),
            rglru_conv_width=4,
            rglru_expand=1,
            tie_embeddings=True,
            scale_embeddings=True,
        ),
    )
