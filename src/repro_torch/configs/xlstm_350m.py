"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 -- alternating
sLSTM + mLSTM blocks [arXiv:2405.04517].  d_ff=0: gating/projections live
inside the cells.  Constant recurrent state => long_500k runs."""
from ..models.config import ModelConfig
from .common import register


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
        norm="rmsnorm", act="swiglu", tie_embeddings=True, remat="dots")


def smoke() -> ModelConfig:
    return full().replace(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                          vocab=512, dtype="float32", remat="none")


register("xlstm-350m", full, smoke)
