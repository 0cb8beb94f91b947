"""Falcon-Mamba 7B — pure Mamba-1, attention-free [arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=65024,
    ssm_state=16, ssm_expand=2, ssm_conv=4,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab_size=512,
        ssm_state=8, ssm_expand=2, ssm_conv=4,
        tie_embeddings=False,
    )
