"""Mixtral 8x22B — 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768,
    n_experts=8, experts_per_token=2,
    sliding_window=4096,
    rope_theta=1e6,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512,
        n_experts=4, experts_per_token=2,
        sliding_window=64,
        tie_embeddings=False,
    )
