"""Wrapper of the fused CGRA sweep kernel.

``sweep_engine`` runs every lane of a packed sweep to EXIT or
``max_steps`` and updates the ``LaneState`` in place.  For CUDA tensors
it launches ``csrc/cgra_sweep.cu`` once per chunk of ``chunk_steps``
instructions until every lane is done; for CPU tensors it runs the plain
version ``ref.sweep_ref``.  There is no fallback from one to the other.
``sweep_engine.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core import isa
from ...core.hwconfig import HwConfig
from ...core.program import N_ROW_FIELDS
from .. import _build
from .ref import (HW_INT_FIELDS, LaneState, SweepTables, chunk_size,
                  sweep_ref)

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                        ctypes.c_float)
_ARGTYPES = ([_P, _I64, _I32, _P, _I32, _P, _P, _P, _F32, _F32, _F32, _F32,
              _P, _P, _P, _P, _I32] + [_P] * 8
             + [_I64, _I32, _I32, _I32, _I32, _I32, _I32, _P])


def _check(tables: SweepTables, hw: HwConfig, gidx: torch.Tensor,
           st: LaneState, rows: int, cols: int, blk_b: int) -> None:
    P = rows * cols
    B = st.mem.shape[0]
    dev = st.mem.device
    want = {"regs": (B, 4, P), "rout": (B, P), "pc": (B,), "done": (B,),
            "t_cc": (B,), "e_acc": (B,), "prev_pc": (B,), "n_exec": (B,)}
    for name, t in st._asdict().items():
        dtype = torch.float32 if name == "e_acc" else torch.int32
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"sweep_engine: state {name} must be a "
                             f"contiguous {dtype} tensor on {dev}")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"sweep_engine: state {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    if st.mem.dim() != 2:
        raise ValueError("sweep_engine: mem must be (B, M)")
    if tuple(tables.tab.shape[1:]) != (N_ROW_FIELDS, P):
        raise ValueError(f"sweep_engine: row table {tuple(tables.tab.shape)}"
                         f" does not fit a {rows}x{cols} array")
    if tables.tab.shape[0] != tables.plen.shape[0] * tables.t_max:
        raise ValueError("sweep_engine: row table is not G * t_max rows")
    operands = {"gidx": (gidx, (B,), None),
                "tab": (tables.tab, None, torch.int32),
                "plen": (tables.plen, None, torch.int32),
                "p_dec": (tables.p_dec, (isa.N_OPS,), torch.float32),
                "p_act": (tables.p_act, (isa.N_OPS,), torch.float32),
                "e_src": (tables.e_src, (isa.N_SRC_KINDS,), torch.float32),
                **{f"hw.{f}": (v, (B,), None)
                   for f, v in hw.as_dict().items()}}
    for name, (t, shape, dtype) in operands.items():
        if (t.device != dev or (shape and tuple(t.shape) != shape)
                or (dtype and (t.dtype != dtype or not t.is_contiguous()))):
            raise ValueError(f"sweep_engine: operand {name} must be on "
                             f"{dev} with shape {shape} and dtype {dtype}")
    if dev.type == "cuda":
        max_threads = kernel_attributes()["max_threads"]
        if P > 32 or P & (P - 1) or not 1 <= blk_b * P <= max_threads:
            raise ValueError(
                f"sweep_engine: the CUDA kernel takes P = rows*cols a power "
                f"of two <= 32 and blk_b <= {max_threads // P} lanes per "
                f"block on this device; got P={P}, blk_b={blk_b}")


def kernel_attributes() -> dict:
    """The compiled sweep kernel's ``max_threads`` per block and
    ``num_regs`` per thread on the current device."""
    fn = _build.library("cgra_sweep").cgra_sweep_attributes
    fn.argtypes = [ctypes.POINTER(ctypes.c_int32)] * 2
    fn.restype = ctypes.c_int
    max_threads, num_regs = ctypes.c_int32(), ctypes.c_int32()
    _build.check(fn(ctypes.byref(max_threads), ctypes.byref(num_regs)),
                 "cgra_sweep_attributes")
    return {"max_threads": max_threads.value, "num_regs": num_regs.value}


def _launch_chunks(tables: SweepTables, hw: HwConfig, gidx: torch.Tensor,
                   st: LaneState, *, rows: int, cols: int, max_steps: int,
                   chunk_steps: Optional[int], blk_b: int) -> None:
    fn = _build.library("cgra_sweep").cgra_sweep_chunk
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    B, M = st.mem.shape
    hw_i = torch.stack([getattr(hw, f).to(torch.int32)
                        for f in HW_INT_FIELDS], dim=1).contiguous()
    hw_f = hw.smul_power_scale.to(torch.float32).contiguous()
    gidx = gidx.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(st.mem.device).cuda_stream
    ptr = lambda t: t.data_ptr()
    K = chunk_size(chunk_steps, max_steps)
    t0 = 0
    while t0 < max_steps and not bool(st.done.all()):
        _build.check(fn(
            ptr(tables.tab), tables.tab.shape[0], tables.t_max,
            ptr(tables.plen), tables.plen.shape[0], ptr(tables.p_dec),
            ptr(tables.p_act), ptr(tables.e_src), tables.p_idle,
            tables.e_sw_op, tables.e_sw_mux, tables.mulzero, ptr(hw_i),
            ptr(hw_f), ptr(gidx), ptr(st.mem), M, *map(ptr, st[1:]),
            B, rows, cols, t0, K, max_steps, blk_b, stream),
            "cgra_sweep_chunk")
        sweep_engine.launches += 1
        t0 += K


def sweep_engine(tables: SweepTables, hw: HwConfig, gidx: torch.Tensor,
                 st: LaneState, *, rows: int, cols: int, max_steps: int,
                 chunk_steps: Optional[int] = 64, blk_b: int = 32) -> None:
    """Run every lane to EXIT or ``max_steps``; ``st`` is updated in place.

    ``hw`` holds one configuration per lane ((B,) fields), ``gidx`` each
    lane's program.  ``blk_b`` is the number of lanes per CUDA block;
    neither it nor ``chunk_steps`` changes a result."""
    _check(tables, hw, gidx, st, rows, cols, blk_b)
    kw = dict(rows=rows, cols=cols, max_steps=max_steps,
              chunk_steps=chunk_steps)
    if st.mem.device.type == "cuda":
        _launch_chunks(tables, hw, gidx, st, blk_b=blk_b, **kw)
    elif st.mem.device.type == "cpu":
        sweep_ref(tables, hw, gidx, st, **kw)
    else:
        raise ValueError(f"sweep_engine: unsupported device {st.mem.device}")


sweep_engine.launches = 0
