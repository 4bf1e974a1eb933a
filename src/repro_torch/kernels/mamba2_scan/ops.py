"""Wrapper of the Mamba2 intra-chunk SSD kernels.

``ssd_intra_chunk`` takes the shapes of
``repro.kernels.mamba2_scan.ops.ssd_intra_chunk`` and is differentiable.
For CUDA tensors its forward launches ``csrc/ssd_intra_chunk.cu`` and
its backward ``csrc/ssd_intra_chunk_bwd.cu`` (``ssd_intra_chunk_bwd``);
for CPU tensors both directions run the plain version
(``ref.intra_chunk_ref``, ``ref.intra_chunk_bwd_ref``).  There is no
fallback from one to the other.  ``ssd_intra_chunk.launches`` and
``ssd_intra_chunk_bwd.launches`` count the kernel launches (one a
backward call: a block per chunk walks its heads);
``route(P, N)`` names the forward kernel's route for a shape,
``last_route()`` the route of its latest launch, ``shared_memory`` its
shared memory a block.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import intra_chunk_bwd_ref, intra_chunk_ref

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 128, 128
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 5 + [_P]
_BWD_ARGTYPES = [_P] * 11 + [_I] * 5 + [_P]


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


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernels (a CUDA tensor) rather than the
    plain version (a CPU tensor, or a meta tensor: shapes only, which
    the dry-run's FLOP count walks); anything else raises."""
    if t.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"ssd_intra_chunk: unsupported device {t.device}")
    return t.device.type == "cuda"


def _check_shape(L, P, N) -> None:
    if L > MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"ssd_intra_chunk: the kernel takes L <= "
                         f"{MAX_CHUNK}, P <= {MAX_HEAD_DIM}, N <= "
                         f"{MAX_STATE}; got L={L}, P={P}, N={N}")


def _launch(x, dt, cum, Bm, Cm, *, out=None) -> torch.Tensor:
    """The forward kernel; ``out`` (contiguous, x's shape, float32)
    receives y if given."""
    G, L, H, P = x.shape
    N = Bm.shape[-1]
    _check_shape(L, P, N)
    fn = _build.function("ssd_intra_chunk", "ssd_intra_chunk_fwd",
                         _ARGTYPES)
    x, dt, cum, Bm, Cm = (t.contiguous() for t in (x, dt, cum, Bm, Cm))
    y = torch.empty_like(x) if out is None else out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), dt.data_ptr(), cum.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), G, L, H, P,
                    N, stream), "ssd_intra_chunk_fwd")
    ssd_intra_chunk.launches += 1
    return y


def _launch_bwd(x, dt, cum, Bm, Cm, dy, *, grads=None):
    """The backward kernel: (dx, ddt, dcum, dB, dC).  ``grads`` (five
    contiguous float32 tensors shaped as the inputs) receive them if
    given."""
    G, L, H, P = x.shape
    N = Bm.shape[-1]
    _check_shape(L, P, N)
    fn = _build.function("ssd_intra_chunk_bwd", "ssd_intra_chunk_bwd",
                         _BWD_ARGTYPES)
    ins = [t.contiguous() for t in (x, dt, cum, Bm, Cm, dy)]
    outs = grads if grads is not None else [torch.empty_like(t)
                                            for t in ins[:5]]
    dx, ddt, dcum, dB, dC = outs
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(*(t.data_ptr() for t in ins), dx.data_ptr(),
                    ddt.data_ptr(), dcum.data_ptr(), dB.data_ptr(),
                    dC.data_ptr(), G, L, H, P, N, stream),
                 "ssd_intra_chunk_bwd")
    ssd_intra_chunk_bwd.launches += 1
    return dx, ddt, dcum, dB, dC


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


def ssd_intra_chunk_bwd(x: torch.Tensor, dt: torch.Tensor,
                        cum: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                        dy: torch.Tensor):
    """(dx, ddt, dcum, dB, dC) of ``ssd_intra_chunk`` given dy: the
    backward kernel for CUDA tensors, the plain backward for CPU
    tensors."""
    _check(x, dt, cum, Bm, Cm)
    return _backward(x, dt, cum, Bm, Cm, dy)


def _backward(x, dt, cum, Bm, Cm, dy):
    if _on_card(x):
        return _launch_bwd(x, dt, cum, Bm, Cm, dy)
    return intra_chunk_bwd_ref(x, dt, cum, Bm, Cm, dy)


class _SSD(torch.autograd.Function):
    """The forward kernel and, for the gradient, the backward kernel;
    inputs are kept only when a gradient is wanted."""

    @staticmethod
    def forward(ctx, x, dt, cum, Bm, Cm, need):
        if _on_card(x):
            y = _launch(x, dt, cum, Bm, Cm)
        else:
            y = intra_chunk_ref(x, dt, cum, Bm, Cm)
        if need:
            ctx.save_for_backward(x, dt, cum, Bm, Cm)
        return y

    @staticmethod
    def backward(ctx, dy):
        return (*_backward(*ctx.saved_tensors, dy), None)


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """x (G,L,H,P); dt/cum (G,L,H); Bm/Cm (G,L,N) -> (G,L,H,P) f32."""
    _check(x, dt, cum, Bm, Cm)
    need = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, cum, Bm, Cm))
    return _SSD.apply(x, dt, cum, Bm, Cm, need)


ssd_intra_chunk.launches = 0
ssd_intra_chunk_bwd.launches = 0
