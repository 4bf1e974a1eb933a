"""olmo-1b [dense]: 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304
-- non-parametric LayerNorm [arXiv:2402.00838]."""
from ..models.config import ModelConfig
from .common import register


def full() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense", n_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=8192, vocab=50304,
        norm="nonparam_ln", act="swiglu", tie_embeddings=True,
        remat="dots")


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=512, dtype="float32",
                          remat="none")


register("olmo-1b", full, smoke)
