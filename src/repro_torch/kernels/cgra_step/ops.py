"""Wrapper of the batched CGRA ALU-dispatch kernel.

``alu_dispatch`` launches ``csrc/cgra_alu.cu`` for CUDA tensors and
takes the plain version (``ref.alu_ref``) only for CPU tensors; there is
no fallback from one to the other.  ``alu_dispatch.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import alu_ref


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]


def _check_planes(ops, a, b) -> None:
    # a few comparisons on the hot path; the loop below names the fault
    if (ops.dtype == a.dtype == b.dtype == torch.int32
            and ops.shape == a.shape == b.shape
            and ops.get_device() == a.get_device() == b.get_device()):
        return
    for name, t in (("ops", ops), ("a", a), ("b", b)):
        if t.dtype != torch.int32:
            raise TypeError(f"alu_dispatch: {name} must be int32, got "
                            f"{t.dtype}")
        if t.shape != ops.shape:
            raise ValueError(f"alu_dispatch: {name} has shape "
                             f"{tuple(t.shape)}, ops {tuple(ops.shape)}")
    raise ValueError("alu_dispatch: planes on different devices")


def _launch(ops, a, b) -> torch.Tensor:
    fn = _build.function("cgra_alu", "cgra_alu_dispatch", _ARGTYPES)
    if not (ops.is_contiguous() and a.is_contiguous()
            and b.is_contiguous()):
        ops, a, b = (t.contiguous() for t in (ops, a, b))
    out = torch.empty_like(ops)
    stream = torch._C._cuda_getCurrentRawStream(ops.get_device())
    _build.check(fn(ops.data_ptr(), a.data_ptr(), b.data_ptr(),
                    out.data_ptr(), ops.numel(), stream), "cgra_alu_dispatch")
    alu_dispatch.launches += 1
    return out


def alu_dispatch(ops: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """int32 opcode/operand planes (any equal shape) -> int32 results."""
    _check_planes(ops, a, b)
    if ops.is_cuda:
        return _launch(ops, a, b)
    if ops.device.type == "cpu":
        return alu_ref(ops, a, b)
    raise ValueError(f"alu_dispatch: unsupported device {ops.device}")


alu_dispatch.launches = 0
