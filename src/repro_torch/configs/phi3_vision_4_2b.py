"""Phi-3-vision 4.2B — phi3-mini backbone + CLIP frontend
[hf:microsoft/Phi-3-vision-128k-instruct].  Backbone only: the vision tower is
a stub of precomputed patch embeddings, an input that comes before the
tokens in training and scoring (``SyntheticLM`` makes them); the serving
path passes none, so the serve CLI refuses this config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32064, head_dim=96,
    frontend="vision_patches", n_frontend_tokens=576,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-vision-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, head_dim=16,
        frontend="vision_patches", n_frontend_tokens=16,
        tie_embeddings=False,
    )
