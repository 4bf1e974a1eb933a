"""whisper-small [audio]: 12L enc + 12L dec, d_model=768 12H (kv=12)
d_ff=3072 vocab=51865 -- enc-dec, conv frontend STUB (input_specs
provides precomputed frame embeddings) [arXiv:2212.04356].

12 heads do not divide the 16-way model axis -> head_dim TP (hd=64)."""
from ..models.config import ModelConfig
from .common import register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865,
        n_enc_layers=12, enc_seq=1500, norm="layernorm", act="gelu",
        attn_tp="head_dim", tie_embeddings=True, remat="dots")


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, n_enc_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
                          enc_seq=16, dtype="float32", remat="none")


register("whisper-small", full, smoke)
