"""Gradient compression with error feedback, in PyTorch.

Mirrors ``repro.train.compression``: each gradient is quantized to int8
in blocks of ``BLOCK`` values with one float32 scale a block, and the
quantization residual is carried to the next step in an error-feedback
buffer (Karimireddy et al. 2019), so the compression bias vanishes over
steps.  The reference's ``compressed_psum`` (a ``shard_map`` collective)
has no counterpart yet: the port trains on one device (ROADMAP.md queue
1).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

BLOCK = 1024
Tree = Dict[str, torch.Tensor]


class EFState(NamedTuple):
    residual: Tree     # float32, keyed like the gradients


def ef_init(grads_like: Tree) -> EFState:
    return EFState(residual={n: torch.zeros_like(g, dtype=torch.float32)
                             for n, g in grads_like.items()})


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of a float32 tensor of any
    shape: (q (n_blocks, BLOCK) int8, scale (n_blocks, 1) float32)."""
    flat = x.reshape(-1)
    blocks = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK)
                                     ).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int]) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (q.float() * scale).reshape(-1)[:n].reshape(tuple(shape))


def compress_decompress(x: torch.Tensor) -> torch.Tensor:
    """The round trip: what the wire carries after the reduce."""
    q, s = quantize_int8(x.float())
    return dequantize_int8(q, s, x.shape)


@torch.no_grad()
def ef_compress_grads(grads: Tree, ef: EFState,
                      groups: Optional[List[List[str]]] = None
                      ) -> Tuple[Tree, EFState]:
    """Error-feedback compression: g' = Q(g + e); e' = (g + e) - g'.
    ``groups`` lists names quantized as one tensor, their values
    concatenated in order (the reference quantizes each leaf of its
    pytree, where the Mamba2 layers' parameters are stacked); every other
    name is quantized alone."""
    groups = groups or []
    grouped = {n for grp in groups for n in grp}
    out, res = {}, {}
    for grp in groups + [[n] for n in grads if n not in grouped]:
        tot = torch.cat([(grads[n].float() + ef.residual[n]).reshape(-1)
                         for n in grp])
        qd = compress_decompress(tot)
        rest = tot - qd
        at = 0
        for n in grp:
            g, k = grads[n], grads[n].numel()
            out[n] = qd[at:at + k].reshape(g.shape).to(g.dtype)
            res[n] = rest[at:at + k].reshape(g.shape)
            at += k
    return {n: out[n] for n in grads}, EFState(
        residual={n: res[n] for n in grads})
