"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].  Attention at layer (i % 8) == 4; MoE every 2nd layer."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536,
    n_experts=16, experts_per_token=2, moe_period=2,
    ssm_state=16, ssm_expand=2, ssm_conv=4,
    attn_period=8, attn_offset=4,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512,
        n_experts=4, experts_per_token=2, moe_period=2,
        ssm_state=8, ssm_expand=2, ssm_conv=4,
        attn_period=8, attn_offset=4,
        tie_embeddings=False,
    )
