"""Plain PyTorch version of the Mamba2 intra-chunk SSD kernel.

The oracle of ``csrc/ssd_intra_chunk.cu`` and the path the wrapper takes
for CPU tensors.  Mirrors ``jax.vmap(repro.kernels.mamba2_scan.ref.
intra_chunk_ref)``, batched over G chunks:

    y[g, i] = sum_{j<=i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j

x (G, L, H, P), dt/cum (G, L, H), Bm/Cm (G, L, N) -> y (G, L, H, P).

The decay is exp of the difference with the pairs above the diagonal
set to -inf, which gives the reference's where(mask, exp(diff), 0) bit
for bit; its gradient is 0 there, where the reference's would be
0 * exp(diff), NaN once exp(diff) overflows.  ``intra_chunk_bwd_ref``,
torch's autograd through it, is the oracle of
``csrc/ssd_intra_chunk_bwd.cu`` and the backward the wrapper takes for
CPU tensors.
"""
from __future__ import annotations

import torch


def intra_chunk_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    L = x.shape[1]
    diff = cum[:, :, None, :] - cum[:, None, :, :]          # (G, L, L, H)
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, :, :, None], diff,
                                  float("-inf")))
    cb = torch.einsum("gin,gjn->gij", Cm, Bm)               # (G, L, L)
    scores = cb[..., None] * decay * dt[:, None, :, :]      # (G, L, L, H)
    return torch.einsum("gijh,gjhp->gihp", scores, x)


def intra_chunk_bwd_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor):
    """(dx, ddt, dcum, dB, dC) of ``intra_chunk_ref`` given the output's
    gradient ``dy``: torch's autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, dt, cum, Bm, Cm)]
        y = intra_chunk_ref(*leaves)
        return torch.autograd.grad(y, leaves, dy)
