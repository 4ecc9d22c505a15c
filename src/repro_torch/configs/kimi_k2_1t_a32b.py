"""kimi-k2-1t-a32b — 61L d=7168 64H GQA kv=8, MoE 384e top-8 + 1 shared,
moe_d_ff=2048, v=163840 (paper-table 1T MoE).

Attention is GQA 64/8 as in the JAX package's config.  The published
Kimi-K2 uses multi-head latent attention (MLA), which neither package
implements; the port adds none.  At full depth the model holds
1,028,299,424,768 parameters (2.06 TB in bfloat16), so one card runs it
cut in depth (``dataclasses.replace(cfg, num_layers=2)``: the dense layer
and one MoE layer, 19,967,682,560 parameters)."""
from repro_torch.configs.base import ModelConfig, RunConfig, TrainConfig


def get_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name='kimi-k2-1t-a32b',
            family='moe',
            num_layers=61,
            d_model=7168,
            num_heads=64,
            num_kv_heads=8,
            head_dim=128,
            d_ff=18432,
            vocab_size=163840,
            num_experts=384,
            num_experts_padded=384,
            top_k=8,
            num_shared_experts=1,
            moe_d_ff=2048,
            first_dense_layers=1,
            rope_theta=50000.0,
        ),
        train=TrainConfig(optimizer="adafactor", master_weights=False,
                          grad_accum=32),
    )


def get_smoke_config() -> RunConfig:
    """Reduced same-family config for CPU smoke tests."""
    return RunConfig(
        model=ModelConfig(
            name='kimi-smoke',
            family='moe',
            num_layers=3,
            d_model=64,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            d_ff=192,
            vocab_size=128,
            num_experts=8,
            num_experts_padded=8,
            top_k=2,
            num_shared_experts=1,
            moe_d_ff=32,
            first_dense_layers=1,
        ),
        train=TrainConfig(optimizer="adafactor", master_weights=False),
    )
