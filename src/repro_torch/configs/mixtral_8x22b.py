"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384/expert
vocab=32768, 8 experts top-2, sliding-window attention [arXiv:2401.04088].

8 experts < 16-way model axis: EP falls back (experts replicated across
the model axis, expert FFN hidden dim TP-sharded; FSDP shards d_model) --
see parallel.sharding.  SWA => long_500k runs with a 4096 ring cache."""
from ..models.config import ModelConfig
from .common import register


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768,
        n_experts=8, top_k=2, window=4096, rope_theta=1_000_000.0,
        norm="rmsnorm", act="swiglu", remat="full")


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=64, vocab=512, n_experts=4, top_k=2, capacity_factor=8.0,
                          window=8, dtype="float32", remat="none")


register("mixtral-8x22b", full, smoke)
