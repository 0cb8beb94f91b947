"""MiniCPM 2B — llama-like dense, WSD schedule [arXiv:2404.06395].
Note: vocab 122753 is padded to a multiple of 256 (``padded_vocab``) and the
padded logits are masked."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm-smoke", family="dense",
        n_layers=2, d_model=72, n_heads=6, n_kv_heads=6, d_ff=144,
        vocab_size=509,  # deliberately odd: exercises vocab padding
        tie_embeddings=True,
    )
