"""Qwen1.5 110B — dense with QKV bias [hf:Qwen/Qwen1.5-110B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
        vocab_size=512,
        qkv_bias=True,
        tie_embeddings=False,
    )
