"""Plain PyTorch version of the Mamba2 intra-chunk SSD kernel.

The oracle of ``csrc/ssd_intra_chunk.cu`` and the path the wrapper takes
for CPU tensors.  Mirrors ``jax.vmap(repro.kernels.mamba2_scan.ref.
intra_chunk_ref)``, batched over G chunks:

    y[g, i] = sum_{j<=i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j

x (G, L, H, P), dt/cum (G, L, H), Bm/Cm (G, L, N) -> y (G, L, H, P).
"""
from __future__ import annotations

import torch


def intra_chunk_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    L = x.shape[1]
    diff = cum[:, :, None, :] - cum[:, None, :, :]          # (G, L, L, H)
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    decay = torch.where(mask[None, :, :, None], torch.exp(diff), 0.0)
    cb = torch.einsum("gin,gjn->gij", Cm, Bm)               # (G, L, L)
    scores = cb[..., None] * decay * dt[:, None, :, :]      # (G, L, L, H)
    return torch.einsum("gijh,gjhp->gihp", scores, x)
