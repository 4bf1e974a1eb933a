"""Wrapper of the flash-attention kernels, in the model's layout.

``attention(q, k, v)`` takes q (B, S, H, hd) and k/v (B, T, KV, hd) as
``repro.kernels.flash_attention.ops.attention`` does, and is
differentiable.  For CUDA tensors its forward launches
``csrc/flash_attention.cu``, which resolves GQA by indexing (query head
h reads kv head h // (H / KV)) and runs bf16 inputs whose head_dim is a
multiple of 8 on the tensor cores (``csrc/flash_hopper.cuh``),
everything else on its FMA kernel (``last_route()`` names the route
of the latest forward); when a gradient is wanted the
forward also writes each row's log-sum-exp (and, for bf16 with head_dim
a multiple of 8, its output in f32), and the backward launches
``csrc/flash_attention_bwd.cu`` (``attention_bwd``): those bf16 calls on
the tensor cores (``csrc/flash_bwd_hopper.cuh``), the rest on its FMA
kernels; ``last_bwd_route()`` names the route of the latest backward.
For CPU tensors both directions run the plain version
(``ref.attention_plain`` and ``ref.attention_bwd_ref``).  There is no
fallback from one to the other.  ``attention.launches`` and
``attention_bwd.launches`` count the kernel launches (two a backward
call on either route: dQ's kernel, then dK/dV's).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .ref import attention_bwd_ref, attention_plain

MAX_HEAD_DIM = 128
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 9 + [_P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 9 + [_P]


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


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernels (a CUDA tensor) rather than the
    plain version (a CPU tensor, or a meta tensor: shapes only, which
    the dry-run's FLOP count walks); anything else raises."""
    if t.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"attention: unsupported device {t.device}")
    return t.device.type == "cuda"


def _keeps_f32_out(q) -> bool:
    """Whether the forward keeps its f32 output for the backward: the
    calls whose backward takes the tensor-core route (bf16, head_dim a
    multiple of 8), where D comes from it."""
    return q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0


def _launch(q, k, v, causal: bool, window: Optional[int], *,
            lse: bool = False, out: Optional[torch.Tensor] = None,
            rows: Optional[torch.Tensor] = None,
            out32: Optional[torch.Tensor] = None):
    """The forward kernel: (out, lse (B, H, S) float32 or None, the
    output in float32 (B, S, H, hd) or None).  With ``lse`` the f32
    output is written too where the backward will read it
    (``_keeps_f32_out``).  ``out`` (contiguous, q's shape and type),
    ``rows`` (contiguous (B, H, S) float32) and ``out32`` (contiguous,
    q's shape, float32) receive them if given."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"attention: the kernel takes head_dim up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    fn = _build.function("flash_attention", "flash_attention_fwd",
                         _ARGTYPES)
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q) if out is None else out
    if not lse:
        rows = out32 = None
    else:
        if rows is None:
            rows = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
        if out32 is None and _keeps_f32_out(q):
            out32 = torch.empty(q.shape, dtype=torch.float32,
                                device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), rows.data_ptr() if lse else None,
                    out32.data_ptr() if out32 is not None else None, B, S,
                    T, H, KV, hd, int(causal), window or 0,
                    int(q.dtype == torch.bfloat16), stream),
                 "flash_attention_fwd")
    attention.launches += 1
    return out, rows, out32


def _launch_bwd(q, k, v, dout, lse, causal: bool, window: Optional[int],
                *, out32: Optional[torch.Tensor] = None, grads=None):
    """The backward kernels: (dq, dk, dv) in the inputs' type.  ``out32``
    is the forward's f32 output where it kept one (bf16 calls then take
    the tensor-core route).  ``grads`` (three contiguous tensors shaped
    and typed as q, k, v) receive them if given."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd",
                         _BWD_ARGTYPES)
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout.to(q.dtype)))
    dq, dk, dv = grads if grads is not None else (
        torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    dsum = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    dout.data_ptr(),
                    out32.contiguous().data_ptr() if out32 is not None
                    else None, lse.contiguous().data_ptr(),
                    dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), B, S, T, H, KV, hd, int(causal),
                    window or 0, int(q.dtype == torch.bfloat16), stream),
                 "flash_attention_bwd")
    attention_bwd.launches += 2
    return dq, dk, dv


def last_route() -> str | None:
    """The route the forward's latest launch in this process took:
    "wgmma" (the tensor-core kernel) or "fma"; None before the first."""
    fn = _build.function("flash_attention", "flash_attention_last_route",
                         [])
    return {1: "wgmma", 0: "fma"}.get(fn())


def last_bwd_route() -> str | None:
    """The route the backward's latest launch in this process took:
    "wgmma" (the tensor-core kernels) or "fma"; None before the first."""
    fn = _build.function("flash_attention_bwd",
                         "flash_attention_bwd_last_route", [])
    return {1: "wgmma", 0: "fma"}.get(fn())


def hopper_shared_memory(hd: int) -> int:
    """Bytes of dynamic shared memory the tensor-core kernel takes a block
    at this head_dim (0 where bf16 calls take the FMA kernel)."""
    return _build.function("flash_attention", "flash_attention_hopper_smem",
                           [_I])(hd)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor, lse: Optional[torch.Tensor], *,
                  causal: bool = True, window: Optional[int] = None,
                  out32: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``attention`` given the output's gradient: the
    backward kernels for CUDA tensors (``lse`` and ``out32`` from the
    forward kernel), the plain backward for CPU tensors (both unused)."""
    _check(q, k, v, window)
    return _backward(q, k, v, dout, lse, out32, causal, window)


def _backward(q, k, v, dout, lse, out32, causal, window):
    if _on_card(q):
        return _launch_bwd(q, k, v, dout, lse, causal, window, out32=out32)
    return attention_bwd_ref(q, k, v, dout, causal=causal, window=window)


class _Attention(torch.autograd.Function):
    """The forward kernel and, for the gradient, the backward kernels;
    the row log-sum-exp (and the f32 output the tensor-core backward
    reads) is written and kept only when a gradient is wanted, so serving
    records nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, need):
        if _on_card(q):
            out, lse, out32 = _launch(q, k, v, causal, window, lse=need)
        else:
            out, lse, out32 = attention_plain(q, k, v, causal=causal,
                                              window=window), None, None
        if need:
            ctx.save_for_backward(q, k, v, lse, out32)
            ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, out32 = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, dout, lse, out32, ctx.causal,
                               ctx.window)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KV, hd).  Returns (B, S, H, hd) in
    q's type."""
    _check(q, k, v, window)
    need = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _Attention.apply(q, k, v, causal, window, need)


attention.launches = 0
attention_bwd.launches = 0
