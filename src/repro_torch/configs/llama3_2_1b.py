"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 -- small llama3 [hf:meta-llama/Llama-3.2-1B]."""
from ..models.config import ModelConfig
from .common import register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense", n_layers=16, d_model=2048,
        n_heads=32, n_kv_heads=8, d_ff=8192, vocab=128256,
        rope_theta=500_000.0, norm="rmsnorm", act="swiglu",
        tie_embeddings=True, remat="dots")


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=512, dtype="float32",
                          remat="none")


register("llama3.2-1b", full, smoke)
