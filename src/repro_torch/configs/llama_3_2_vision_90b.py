"""llama-3.2-vision-90b — 100L d=8192 64H GQA kv=8 d_ff=28672 v=128256;
80 self-attn + 20 gated cross-attn layers (every 5th).  Vision frontend is
a STUB, as in the JAX package: the caller supplies precomputed patch
embeddings ``image_embeds`` [B, 1600, d].  At full depth the model holds
87,666,794,536 parameters (175 GB in bfloat16); one card runs it cut in
depth (25 layers: 20 self-attention and 5 cross-attention)."""
from repro_torch.configs.base import ModelConfig, RunConfig, TrainConfig


def get_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name='llama-3.2-vision-90b',
            family='vlm',
            num_layers=100,
            d_model=8192,
            num_heads=64,
            num_kv_heads=8,
            head_dim=128,
            d_ff=28672,
            vocab_size=128256,
            cross_attn_every=5,
            num_vision_tokens=1600,
            rope_theta=500000.0,
        ),
        train=TrainConfig(grad_accum=16),
    )


def get_smoke_config() -> RunConfig:
    """Reduced same-family config for CPU smoke tests."""
    return RunConfig(
        model=ModelConfig(
            name='llama-vision-smoke',
            family='vlm',
            num_layers=5,
            d_model=64,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            d_ff=192,
            vocab_size=128,
            cross_attn_every=5,
            num_vision_tokens=16,
        ),
        train=TrainConfig(),
    )
