"""Plain PyTorch version of the flash-attention kernel.

The oracle of ``csrc/flash_attention.cu`` and the path the wrapper takes
for CPU tensors.  Mirrors ``repro.kernels.flash_attention.ref``: layout
q (B, H, S, hd), k/v (B, H, T, hd) with kv heads already expanded, the
softmax materialised in float32, causal and sliding-window masks by
absolute position.
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
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(),
                          k.float()) / math.sqrt(hd)
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
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype)
