"""Plain PyTorch version of the flash-attention kernel.

The oracle of ``csrc/flash_attention.cu`` and the path the wrapper takes
for CPU tensors.  Mirrors ``repro.kernels.flash_attention.ref``: layout
q (B, H, S, hd), k/v (B, H, T, hd) with kv heads already expanded, the
softmax materialised in float32 (float64 inputs stay float64), causal
and sliding-window masks by absolute position.

``attention_plain`` is the same in the model's layout (q (B, S, H, hd),
k/v (B, T, KV, hd)); ``attention_bwd_ref``, torch's autograd through it,
is the oracle of ``csrc/flash_attention_bwd.cu`` and the backward the
wrapper takes for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Naive materialised-softmax attention; f32 accumulation, output in
    q's type."""
    hd = q.shape[-1]
    work = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(work),
                          k.to(work)) / math.sqrt(hd)
    S, T = logits.shape[-2:]
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.to(work))
    return out.to(q.dtype)


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, H, T, hd), each kv head repeated H/KV times."""
    return k.transpose(1, 2).repeat_interleave(n_heads // k.shape[2], dim=1)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """``attention_ref`` in the model's layout, GQA by expanding the kv
    heads: q (B, S, H, hd), k/v (B, T, KV, hd) -> (B, S, H, hd)."""
    H = q.shape[2]
    out = attention_ref(q.transpose(1, 2), expand_kv(k, H), expand_kv(v, H),
                        causal=causal, window=window)
    return out.transpose(1, 2)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      window: Optional[int] = None):
    """(dq, dk, dv) of ``attention_plain`` at (q, k, v) given the output's
    gradient ``dout``, each in its input's type: torch's autograd, with
    bfloat16 inputs taken as float32 leaves so that every sum (the GQA
    sum over a kv head's query heads too) is float32 and each gradient
    rounds once."""
    work = torch.promote_types(q.dtype, torch.float32)
    with torch.enable_grad():
        leaves = [t.detach().to(work).requires_grad_(True)
                  for t in (q, k, v)]
        out = attention_plain(*leaves, causal=causal, window=window)
        grads = torch.autograd.grad(out, leaves, dout.to(work))
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
