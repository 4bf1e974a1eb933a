"""Shared building blocks of the served models, in PyTorch.

Mirrors ``repro.models.layers``: norms, RoPE and qwen2-vl's M-RoPE,
attention with optional q/k/v biases (every full-sequence call through
the flash-attention kernel; decode against a KV cache, a ring buffer for
sliding-window configs), the whisper decoder's cross-attention (k/v from
the encoder's output, static through decode) and attention without
RoPE (whisper's learned absolute positions), the SwiGLU and GELU MLPs,
the tied or untied embedding and the logits with their
padded-vocabulary mask.  Parameters keep the reference's shapes and
names (``wq`` is (D, H, hd), ...), so ``repro_torch.convert`` carries
weights across by name.  Each module names its parameters' logical axes
at construction (``logical_axes``, the reference's ``dense_init(key,
shape, axes)``; ``initlib.param_axes`` collects them) for the sharding
rules; the activations' ``constrain`` calls have no counterpart, as one
process keeps every tensor whole.  Parameters are held without
gradients, as serving needs them; a trainer turns gradients on
(``params.requires_grad_(True)``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..kernels.flash_attention.ops import attention
from .config import ModelConfig
from .initlib import dense_init, ones_init, zeros_init

NEG_INF = -1e9
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cdt(cfg: ModelConfig) -> torch.dtype:
    """The activation (compute) type."""
    return DTYPES[cfg.dtype]


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """``scale`` (rmsnorm, layernorm), ``bias`` (layernorm); olmo's
    nonparam_ln has neither."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.scale = self.bias = None
        ax = (None,) if cfg.norm_param_replicated else ("embed_tp",)
        self.logical_axes = {"scale": ax, "bias": ax}
        if cfg.norm in ("rmsnorm", "layernorm"):
            self.scale = param(ones_init((d,), device))
        if cfg.norm == "layernorm":
            self.bias = param(zeros_init((d,), device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self, self.cfg, x)


def apply_norm(p: Norm, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.bf16_elementwise and x.dtype != torch.float32:
        # f32 statistics, working-type multiplies
        xf = x.float()
        if cfg.norm == "rmsnorm":
            s = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
            return x * s.to(x.dtype) * p.scale.to(x.dtype)
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (x - mu.to(x.dtype)) * torch.rsqrt(var + 1e-5).to(x.dtype)
        if cfg.norm == "layernorm":
            y = y * p.scale.to(x.dtype) + p.bias.to(x.dtype)
        return y
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        y = y * p.scale.float()
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        if cfg.norm == "layernorm":
            y = y * p.scale.float() + p.bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE and qwen2-vl M-RoPE)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, hd: int, theta: float,
                 mrope_sections: Optional[Tuple[int, int, int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (B, S) integers, or (B, S, 3) for M-RoPE.  Returns
    cos/sin of shape (B, S, 1, hd // 2), float32 (head-broadcastable).

    M-RoPE (Qwen2-VL): the hd/2 frequency slots are split into
    (temporal, height, width) sections, each driven by its own position
    component; identical components give 1-D RoPE exactly."""
    dev = positions.device
    inv = torch.tensor(theta, dtype=torch.float32, device=dev) ** (
        -torch.arange(0, hd, 2, dtype=torch.float32, device=dev) / hd)
    if positions.dim() == 3:
        t, h, w = mrope_sections
        if t + h + w != hd // 2:
            raise ValueError(f"mrope sections {mrope_sections} must cover "
                             f"head_dim/2 = {hd // 2}")
        sec = torch.repeat_interleave(torch.arange(3, device=dev),
                                      torch.tensor([t, h, w], device=dev),
                                      output_size=hd // 2)
        ang = positions.float()[:, :, sec] * inv
    else:
        ang = positions.float()[..., None] * inv
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               bf16_mul: bool = False) -> torch.Tensor:
    """x: (B, S, H, hd); rotate-half convention.  bf16_mul rotates in the
    working type (cfg.bf16_elementwise)."""
    half = x.shape[-1] // 2
    if bf16_mul and x.dtype != torch.float32:
        x1, x2 = x[..., :half], x[..., half:]
        c, s = cos.to(x.dtype), sin.to(x.dtype)
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Decode-time cache.  ``k``/``v``: (B, C, KV, hd), C the context (or
    the window for SWA configs, a ring buffer).  ``pos``: (B, C) int32
    absolute positions, -1 for an empty row."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        g = generator
        self.wq = param(dense_init((D, H, hd), g, device, fan_in=D))
        self.wk = param(dense_init((D, KV, hd), g, device, fan_in=D))
        self.wv = param(dense_init((D, KV, hd), g, device, fan_in=D))
        self.wo = param(dense_init((H, hd, D), g, device, fan_in=H * hd))
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq = param(zeros_init((H, hd), device))
            self.bk = param(zeros_init((KV, hd), device))
            self.bv = param(zeros_init((KV, hd), device))
        if cfg.attn_tp == "heads":
            h_axes = ("embed", "heads", "head_dim")
            kv_axes = ("embed", "kv_heads", "head_dim")
            o_axes = ("heads", "head_dim", "embed")
        else:  # head_dim TP: heads replicated, hd sharded
            h_axes = kv_axes = ("embed", None, "head_dim_tp")
            o_axes = (None, "head_dim_tp", "embed")
        self.logical_axes = {"wq": h_axes, "wk": kv_axes, "wv": kv_axes,
                             "wo": o_axes, "bq": h_axes[1:],
                             "bk": kv_axes[1:], "bv": kv_axes[1:]}

    def forward(self, x, **kw):
        return attention_forward(self, self.cfg, x, **kw)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") in x's type."""
    D, H, K = w.shape
    return (x @ w.to(x.dtype).reshape(D, H * K)).unflatten(-1, (H, K))


def _out_proj(y: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") in y's type."""
    H, K, D = wo.shape
    return y.flatten(-2) @ wo.to(y.dtype).reshape(H * K, D)


def _q(p: Attention, x: torch.Tensor) -> torch.Tensor:
    q = _proj(x, p.wq)
    return q if p.bq is None else q + p.bq.to(x.dtype)


def _qkv(p: Attention, x: torch.Tensor,
         xkv: Optional[torch.Tensor] = None):
    """q from ``x``; k and v from ``xkv`` (cross-attention) or ``x``."""
    xkv = x if xkv is None else xkv
    q, k, v = _q(p, x), _proj(xkv, p.wk), _proj(xkv, p.wv)
    if p.bk is not None:
        dt = x.dtype
        k, v = k + p.bk.to(dt), v + p.bv.to(dt)
    return q, k, v


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    return rope_cos_sin(positions, cfg.hd, cfg.rope_theta,
                        cfg.mrope_sections if cfg.mrope else None)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float):
    """q: (B,S,H,hd), k: (B,T,KV,hd) -> logits (B,KV,G,S,T), G = H//KV."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    return torch.einsum("bskgh,btkh->bkgst", qg, k) * scale


def _gqa_combine(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,KV,G,S,T), v: (B,T,KV,hd) -> (B,S,H,hd)."""
    B, KV, G, S, T = probs.shape
    y = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return y.reshape(B, S, KV * G, v.shape[-1])


def attention_forward(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
                      positions: Optional[torch.Tensor] = None,
                      causal: bool = True,
                      xkv: Optional[torch.Tensor] = None,
                      window: Optional[int] = None, use_rope: bool = True):
    """Full-sequence attention (train / prefill / encoder / cross) through
    the flash-attention kernel.  ``xkv`` (B, T, D): the keys' and values'
    input (cross-attention), ``x`` by default.  ``positions``: (B, S), or
    (B, S, 3) for M-RoPE; 0..S-1 by default.  With ``use_rope`` q is
    rotated, and k too unless it comes from ``xkv``.  Returns
    (y, (k, v)); k/v build the decode cache (or, for cross-attention,
    the static encoder memory)."""
    q, k, v = _qkv(p, x, xkv)
    if use_rope:
        if positions is None:
            positions = torch.arange(x.shape[1],
                                     device=x.device).expand(x.shape[:2])
        cos, sin = _rope(cfg, positions)
        q = apply_rope(q, cos, sin, cfg.bf16_elementwise)
        if xkv is None:
            k = apply_rope(k, cos, sin, cfg.bf16_elementwise)
    y = attention(q, k, v, causal=causal, window=window)
    return _out_proj(y, p.wo), (k, v)


def init_kv_cache(cfg: ModelConfig, batch: int, context: int,
                  dtype: torch.dtype, device: torch.device) -> KVCache:
    """context = min(context, window) for SWA configs: the ring buffer
    bounds decode memory whatever the sequence length."""
    c = context if cfg.window is None else min(context, cfg.window)
    shape = (batch, c, cfg.n_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.full((batch, c), -1, dtype=torch.int32,
                                  device=device))


def attention_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     cache: KVCache, index: int, *,
                     enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     = None,
                     use_rope: bool = True) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode.  x: (B, 1, D); index: the absolute position,
    shared by the batch.  Writes row ``index % C`` of the cache in place
    (the reference returns an updated copy) and returns it.  Masking is by
    the absolute positions in ``cache.pos``, so ring overwrites are
    exact.  M-RoPE configs take ``index`` as all three components.
    ``enc_kv`` ((B, T, KV, hd) each, in x's type): cross-attention over
    that static memory, unmasked and unrotated; the cache is returned
    untouched."""
    if enc_kv is not None:
        k, v = enc_kv
        logits = _gqa_scores(_q(p, x), k,
                             1.0 / math.sqrt(cfg.hd)).float()
        probs = torch.softmax(logits, -1).to(x.dtype)
        return _out_proj(_gqa_combine(probs, v), p.wo), cache
    B = x.shape[0]
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x)
    if use_rope:
        cos, sin = _rope(cfg, pos[..., None].expand(B, 1, 3) if cfg.mrope
                         else pos)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    slot = index % cache.k.shape[1]
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    cache.pos[:, slot] = index
    logits = _gqa_scores(q, cache.k.to(x.dtype),
                         1.0 / math.sqrt(cfg.hd)).float()
    valid = (cache.pos >= 0) & (cache.pos <= index)
    if cfg.window is not None:
        valid &= cache.pos > index - cfg.window
    logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, -1).to(x.dtype)
    y = _gqa_combine(probs, cache.v.to(x.dtype))
    return _out_proj(y, p.wo), cache


def cache_from_prefill(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                       context: int) -> KVCache:
    """A decode cache from prefill's k/v (the last ``window`` positions for
    SWA configs), padded with empty rows to the context."""
    B, S = k.shape[0], k.shape[1]
    C = context if cfg.window is None else min(context, cfg.window)
    kk, vv = k[:, -C:], v[:, -C:]
    n = kk.shape[1]
    pos = torch.arange(S - n, S, dtype=torch.int32,
                       device=k.device).expand(B, n)
    pad = C - n
    if pad > 0:
        kk = nn.functional.pad(kk, (0, 0, 0, 0, 0, pad))
        vv = nn.functional.pad(vv, (0, 0, 0, 0, 0, pad))
        pos = nn.functional.pad(pos, (0, pad), value=-1)
    return KVCache(kk, vv, pos)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``wg``, ``wu``, ``wd``) or GELU (``wu``, ``wd``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        D, F, g = cfg.d_model, cfg.d_ff, generator
        self.wg = None
        if cfg.act == "swiglu":
            self.wg = param(dense_init((D, F), g, device))
        self.wu = param(dense_init((D, F), g, device))
        self.wd = param(dense_init((F, D), g, device, fan_in=F))
        self.logical_axes = {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"),
                             "wd": ("mlp", "embed")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self, self.cfg, x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (PyTorch's
    default is the exact erf form)."""
    return nn.functional.gelu(x, approximate="tanh")


def apply_mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.act == "swiglu":
        h = nn.functional.silu(x @ p.wg.to(dt)) * (x @ p.wu.to(dt))
    else:
        h = gelu(x @ p.wu.to(dt))
    return h @ p.wd.to(dt)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """``table`` (Vp, D) and, unless the config ties them, ``head``
    (D, Vp)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        Vp, D = cfg.vocab_padded, cfg.d_model
        self.table = param(dense_init((Vp, D), generator, device, fan_in=D))
        self.head = None
        if not cfg.tie_embeddings:
            self.head = param(dense_init((D, Vp), generator, device))
        self.logical_axes = {"table": ("vocab", "embed"),
                             "head": ("embed", "vocab")}


def embed_tokens(p: Embedding, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return p.table[tokens.long()].to(cdt(cfg))


def logits_from_hidden(p: Embedding, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """float32 logits over the padded vocabulary; the padding columns
    carry NEG_INF so a log-sum-exp over them is exact.  Tied configs
    take the table's transpose for the head."""
    w = p.table.T if cfg.tie_embeddings else p.head
    out = x.float() @ w.float()
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        out = out.masked_fill(pad, NEG_INF)
    return out
