"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 -- llama-arch small [hf:HuggingFaceTB/SmolLM].

15 heads do not divide the 16-way model axis; TP falls back to head_dim
sharding (hd = 64 = 4 x 16)."""
from ..models.config import ModelConfig
from .common import register


def full() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense", n_layers=32, d_model=960,
        n_heads=15, n_kv_heads=5, d_ff=2560, vocab=49152,
        norm="rmsnorm", act="swiglu", tie_embeddings=True,
        attn_tp="head_dim", remat="dots")


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
                          d_ff=96, vocab=512, dtype="float32", remat="none")


register("smollm-360m", full, smoke)
