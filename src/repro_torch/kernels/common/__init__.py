"""Sources shared by the CUDA kernels (``csrc/hopper_async.cuh``) and a
probe for the card tests: ``poison_shared_memory`` fills every SM's
dynamic shared memory with NaN (``csrc/smem_poison.cu``), so that a
kernel launched next that reads a shared word it never wrote returns
NaN instead of a stale, plausible value."""
from __future__ import annotations

import ctypes

import torch

from .. import _build


def poison_shared_memory(device=None) -> int:
    """Launch the poison on the current stream of ``device``; returns the
    bytes each block filled.  Raises on a CUDA error."""
    fn = _build.function("smem_poison", "smem_poison", [ctypes.c_void_p])
    n = fn(torch.cuda.current_stream(device).cuda_stream)
    if n <= 0:
        raise RuntimeError(f"smem_poison: CUDA error {-n} at launch")
    return n
