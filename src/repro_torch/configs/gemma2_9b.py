"""Gemma-2 9B — alternating local/global attention, logit softcapping,
GeGLU, pre+post block norms [arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab_size=256000, head_dim=256,
    local_global=True, local_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    post_block_norms=True,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=32,
        local_global=True, local_window=32,
        attn_softcap=50.0, final_softcap=30.0,
        post_block_norms=True,
        act="gelu",
        tie_embeddings=True,
    )
