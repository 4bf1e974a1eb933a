"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 -- M-RoPE, dynamic resolution (patch frontend STUB)
[arXiv:2409.12191].

28 heads do not divide the 16-way model axis -> head_dim TP (hd=128).
M-RoPE sections (16, 24, 24) over head_dim/2 = 64."""
from ..models.config import ModelConfig
from .common import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
        n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064,
        rope_theta=1_000_000.0, mrope=True, mrope_sections=(16, 24, 24),
        qkv_bias=True, attn_tp="head_dim", norm="rmsnorm", act="swiglu",
        n_patches=256, remat="full")


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=512, n_patches=4,
                          mrope_sections=(4, 2, 2), dtype="float32",
                          remat="none")


register("qwen2-vl-7b", full, smoke)
