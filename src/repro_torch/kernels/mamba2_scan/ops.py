"""Wrapper of the Mamba2 intra-chunk SSD kernel.

``ssd_intra_chunk`` takes the shapes of
``repro.kernels.mamba2_scan.ops.ssd_intra_chunk``.  For CUDA tensors it
launches ``csrc/ssd_intra_chunk.cu``; for CPU tensors it runs the plain
version ``ref.intra_chunk_ref``.  There is no fallback from one to the
other.  ``ssd_intra_chunk.launches`` counts the kernel launches;
``route(P, N)`` names the kernel's route for a shape, ``last_route()``
the route of its latest launch, ``shared_memory`` its shared memory a
block.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import intra_chunk_ref

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 128, 128
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 5 + [_P]


def _check(x, dt, cum, Bm, Cm) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_intra_chunk: x must be (G, L, H, P), got "
                         f"{tuple(x.shape)}")
    G, L, H, P = x.shape
    want = {"dt": (dt, (G, L, H)), "cum": (cum, (G, L, H)),
            "Bm": (Bm, (G, L, Bm.shape[-1])),
            "Cm": (Cm, (G, L, Bm.shape[-1]))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_intra_chunk: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    for name, t in (("x", x), *((n, t) for n, (t, _) in want.items())):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_intra_chunk: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError("ssd_intra_chunk: inputs on different devices")


def _launch(x, dt, cum, Bm, Cm) -> torch.Tensor:
    G, L, H, P = x.shape
    N = Bm.shape[-1]
    if L > MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"ssd_intra_chunk: the kernel takes L <= "
                         f"{MAX_CHUNK}, P <= {MAX_HEAD_DIM}, N <= "
                         f"{MAX_STATE}; got L={L}, P={P}, N={N}")
    fn = _build.function("ssd_intra_chunk", "ssd_intra_chunk_fwd",
                         _ARGTYPES)
    x, dt, cum, Bm, Cm = (t.contiguous() for t in (x, dt, cum, Bm, Cm))
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), dt.data_ptr(), cum.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), G, L, H, P,
                    N, stream), "ssd_intra_chunk_fwd")
    ssd_intra_chunk.launches += 1
    return y


def route(P: int, N: int) -> str:
    """The kernel's route for head dim P and state N (tensors on 16-byte
    boundaries, as fresh allocations are): "tma" (TMA loads) or
    "cp.async" (4-byte cp.async loads).  Both run the products in f64 on
    the tensor cores."""
    fn = _build.function("ssd_intra_chunk", "ssd_intra_chunk_route",
                         [_I, _I])
    return "tma" if fn(P, N) else "cp.async"


def last_route() -> str | None:
    """The route the kernel's latest launch in this process took, from
    its shape and its tensors' addresses ("tma" or "cp.async"); None
    before the first launch."""
    fn = _build.function("ssd_intra_chunk", "ssd_intra_chunk_last_route",
                         [])
    return {1: "tma", 0: "cp.async"}.get(fn())


def shared_memory(P: int, N: int) -> int:
    """Bytes of dynamic shared memory a block of the kernel takes."""
    return _build.function("ssd_intra_chunk", "ssd_intra_chunk_smem",
                           [_I, _I])(P, N)


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """x (G,L,H,P); dt/cum (G,L,H); Bm/Cm (G,L,N) -> (G,L,H,P) f32."""
    _check(x, dt, cum, Bm, Cm)
    if x.device.type == "cuda":
        return _launch(x, dt, cum, Bm, Cm)
    if x.device.type == "cpu":
        return intra_chunk_ref(x, dt, cum, Bm, Cm)
    raise ValueError(f"ssd_intra_chunk: unsupported device {x.device}")


ssd_intra_chunk.launches = 0
