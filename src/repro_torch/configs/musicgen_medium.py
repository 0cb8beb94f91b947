"""MusicGen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].
Backbone only: the EnCodec frontend is a stub of precomputed frame
embeddings, an input that comes before the tokens in training and
scoring (``SyntheticLM`` makes them); the serving path passes none, so
the serve CLI refuses this config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048,
    act="gelu",
    frontend="audio_frames", n_frontend_tokens=256,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256,
        act="gelu",
        frontend="audio_frames", n_frontend_tokens=16,
        tie_embeddings=False,
    )
