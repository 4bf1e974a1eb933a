"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8)
d_ff=512/expert vocab=49155, 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

32 experts / 16-way model axis => true EP, 2 experts per device."""
from ..models.config import ModelConfig
from .common import register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe", n_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155,
        n_experts=32, top_k=8, norm="rmsnorm", act="swiglu",
        tie_embeddings=True, remat="dots")


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=32, vocab=515, n_experts=8, top_k=2, capacity_factor=8.0,
                          dtype="float32", remat="none")


register("granite-moe-1b-a400m", full, smoke)
