"""Model configuration schema for the assigned architectures.

One frozen dataclass describes every family (dense / moe / encdec / vlm /
hybrid / ssm); family-specific fields are zero/None when unused.  Configs
for the 10 assigned architectures live in ``repro.configs`` and are
constructed *exactly* from the public hyperparameters in the brief.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Embedding tables are padded so the vocab dim shards cleanly; the
    loss masks the padding columns (exact log-sum-exp, see train/loss)."""
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | encdec | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention ------------------------------------------------------------
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window attention (SWA) size
    mrope: bool = False           # qwen2-vl multimodal RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)   # halves of head_dim
    attn_tp: str = "heads"        # heads | head_dim  (TP strategy)
    qkv_bias: bool = False

    # block structure --------------------------------------------------------
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparam_ln
    act: str = "swiglu"           # swiglu | gelu
    tie_embeddings: bool = False
    n_enc_layers: int = 0         # encdec: encoder depth
    enc_seq: int = 1500           # encdec: frame count from the (stub) frontend
    n_patches: int = 256          # vlm: patch count from the (stub) frontend

    # moe --------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ssm / hybrid -----------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    shared_attn_every: int = 0    # zamba2: shared block period
    slstm_every: int = 2          # xlstm: every k-th block is an sLSTM

    # numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"
    logit_dtype: str = "float32"
    remat: str = "full"           # full | dots | none
    # scan-over-layers keeps HLO O(1) in depth; the dry-run unrolls instead
    # because XLA cost_analysis counts a while body once (trip count
    # ignored), which would corrupt the roofline FLOP/byte terms.
    unroll_layers: bool = False

    # ---- beyond-paper performance knobs (EXPERIMENTS.md §Perf) ----------
    # ce_impl="onehot": cross-entropy as a vocab-contracting einsum so the
    # label gather never all-gathers the vocab-sharded logits.
    ce_impl: str = "gather"       # gather | onehot
    # norm_param_replicated: replicate 1-D norm scales/biases instead of
    # model-sharding them.  The baseline's "embed_tp" annotation on these
    # vectors propagates a last-dim sharding onto the residual stream and
    # costs a full-activation all-gather + all-reduce per use (~105 GB/dev
    # /step on llama train_4k) -- §Perf iteration 2's finding.
    norm_param_replicated: bool = False
    # bf16_elementwise: norm/RoPE keep their *reductions* (mean, rsqrt,
    # cos/sin) in f32 but do the big (B,S,D)-shaped multiplies in bf16.
    # The baseline's f32 upcast makes every backward dot through those
    # sites produce f32 partial sums, so the structural TP all-reduces of
    # the residual stream move 2x the bytes (§Perf iteration 4).
    bf16_elementwise: bool = False
    # seq_shard: sequence/context parallelism -- activations shard their
    # seq dim over the model axis (weights FSDP-only).  The right TP mode
    # when head counts don't divide the axis (smollm 15H, whisper 12H,
    # qwen2 28H): contracting a head_dim-sharded QK would all-reduce the
    # full (S, T) score tensor every layer.
    seq_shard: bool = False

    # ----------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_subquadratic(self) -> bool:
        """Bounded per-token state: SWA, SSM and hybrid families qualify
        (the long_500k shape is only lowered for these; DESIGN.md
        Arch-applicability)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def has_decoder(self) -> bool:
        return True   # every assigned arch has an autoregressive stack

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "ModelConfig":
        assert self.family in ("dense", "moe", "encdec", "vlm", "hybrid",
                               "ssm")
        if self.family != "ssm" or self.name.startswith("zamba"):
            assert self.n_heads % self.n_kv_heads == 0
        if self.family == "moe":
            assert 0 < self.top_k <= self.n_experts
        if self.family == "encdec":
            assert self.n_enc_layers > 0
        assert self.attn_tp in ("heads", "head_dim")
        assert self.norm in ("rmsnorm", "layernorm", "nonparam_ln")
        assert self.act in ("swiglu", "gelu")
        return self


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell is runnable (DESIGN.md skip table)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "skip(full-attn): unbounded KV cache at 500k"
    return True, ""
