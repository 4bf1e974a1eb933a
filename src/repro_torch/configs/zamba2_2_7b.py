"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 -- Mamba2 backbone + shared attention block
every 6 layers [arXiv:2411.15242].

Constant SSM state + O(context) shared-block attention per token =>
long_500k runs."""
from ..models.config import ModelConfig
from .common import register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
        ssm_state=64, ssm_head_dim=64, shared_attn_every=6,
        norm="rmsnorm", act="swiglu", remat="full")


def smoke() -> ModelConfig:
    return full().replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=512, ssm_state=16,
                          ssm_head_dim=16, shared_attn_every=2,
                          dtype="float32", remat="none")


register("zamba2-2.7b", full, smoke)
