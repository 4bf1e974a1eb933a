"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 -- GQA, RoPE, sliding-window 4096, LayerNorm+GELU, biases
[arXiv:2402.19173].  SWA => bounded decode cache => long_500k runs."""
from ..models.config import ModelConfig
from .common import register


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=4, d_ff=24576, vocab=49152,
        rope_theta=100_000.0, window=4096, qkv_bias=True,
        norm="layernorm", act="gelu", remat="full")


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=512, window=8, dtype="float32",
                          remat="none")


register("starcoder2-15b", full, smoke)
