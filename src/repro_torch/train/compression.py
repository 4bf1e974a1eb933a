"""Gradient compression with error feedback, in PyTorch.

Mirrors ``repro.train.compression``: each gradient is quantized to int8
in blocks of ``BLOCK`` values with one float32 scale a block, and the
quantization residual is carried to the next step in an error-feedback
buffer (Karimireddy et al. 2019), so the compression bias vanishes over
steps.  ``compressed_psum`` is the reference's ``shard_map`` collective
in single-controller form: one process holds every shard's tensor and
sums their int8 payloads on the first shard's device.
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
    pad = (-flat.numel()) % BLOCK
    blocks = (torch.nn.functional.pad(flat, (0, pad)) if pad
              else flat).reshape(-1, BLOCK)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by
    # its reciprocal, which rounds differently from the host's division
    scale = blocks.abs().amax(dim=1, keepdim=True) / torch.full(
        (), 127.0, device=x.device)
    q = (blocks / torch.clamp(scale, min=1e-12)).round_().clamp_(
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


@torch.no_grad()
def compressed_psum(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The reference's ``compressed_psum`` over the shards of a mesh axis,
    one tensor a shard (each on its own device): every shard's tensor is
    int8-quantized, the payloads summed as int32 and the scales as
    float32 on the first shard's device, in shard order, and the sum
    dequantized with the averaged scale (the reference's proxy: the sum
    of the scales over the shard count).  Returns the result once for
    each shard, on that shard's device, in the input's type.  On the
    wire: each shard's int8 payload and its float32 scale a block."""
    if not shards:
        raise ValueError("compressed_psum: no shards")
    shape, home = shards[0].shape, shards[0].device
    qsum = ssum = None
    for x in shards:
        if x.shape != shape:
            raise ValueError(f"compressed_psum: shard shapes differ: "
                             f"{tuple(x.shape)} against {tuple(shape)}")
        q, s = quantize_int8(x.float())
        q, s = q.to(home), s.to(home)
        if qsum is None:
            qsum, ssum = q.to(torch.int32), s
        else:
            qsum.add_(q)
            ssum = ssum + s
    n = torch.tensor(float(len(shards)), device=home)
    out = dequantize_int8(qsum, ssum / n, shape).to(shards[0].dtype)
    return [out if x.device == home else out.to(x.device) for x in shards]
