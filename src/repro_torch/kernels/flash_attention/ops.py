"""Wrapper of the flash-attention kernel, in the model's layout.

``attention(q, k, v)`` takes q (B, S, H, hd) and k/v (B, T, KV, hd) as
``repro.kernels.flash_attention.ops.attention`` does.  For CUDA tensors
it launches ``csrc/flash_attention.cu``, which resolves GQA by indexing
(query head h reads kv head h // (H / KV)) and runs bf16 inputs whose
head_dim is a multiple of 8 on the tensor cores (``csrc/flash_hopper.cuh``),
everything else on its FMA kernel; for CPU tensors it expands the kv
heads and runs the plain version ``ref.attention_ref``.  There is
no fallback from one to the other.  ``attention.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .ref import attention_ref

MAX_HEAD_DIM = 128
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 9 + [_P]


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention: q must be (B, S, H, hd) and k, v "
                         f"(B, T, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2] != 0:
        raise ValueError(f"attention: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"attention: q, k, v must share float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("attention: q, k, v on different devices")
    if window is not None and window < 1:
        raise ValueError(f"attention: window must be positive, got {window}")


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, H, T, hd), each kv head repeated H/KV times."""
    return k.transpose(1, 2).repeat_interleave(n_heads // k.shape[2], dim=1)


def _launch(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"attention: the kernel takes head_dim up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    fn = _build.function("flash_attention", "flash_attention_fwd",
                         _ARGTYPES)
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), B, S, T, H, KV, hd, int(causal),
                    window or 0, int(q.dtype == torch.bfloat16), stream),
                 "flash_attention_fwd")
    attention.launches += 1
    return out


def hopper_shared_memory(hd: int) -> int:
    """Bytes of dynamic shared memory the tensor-core kernel takes a block
    at this head_dim (0 where bf16 calls take the FMA kernel)."""
    return _build.function("flash_attention", "flash_attention_hopper_smem",
                           [_I])(hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KV, hd).  Returns (B, S, H, hd) in
    q's type."""
    _check(q, k, v, window)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    if q.device.type == "cpu":
        H = q.shape[2]
        out = attention_ref(q.transpose(1, 2), _expand_kv(k, H),
                            _expand_kv(v, H), causal=causal, window=window)
        return out.transpose(1, 2)
    raise ValueError(f"attention: unsupported device {q.device}")


attention.launches = 0
