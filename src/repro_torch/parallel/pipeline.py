"""GPipe-style pipeline parallelism over a stage mesh, single controller.

The reference splits a transformer trunk's layers into S contiguous
stages (parameters stacked per stage) laid on a "stage" mesh axis, and
runs the classic GPipe schedule under ``shard_map``: tick t runs
microbatch (t - s) on stage s, and the activations hop stage -> stage+1
by ``ppermute``.  The bubble fraction is (S-1)/(M+S-1), so M >= 4S keeps
it under ~20%.

Here one process drives every stage.  Stage s's parameters live on mesh
entry s; the hop is a copy of the stage's output to the next entry's
device (nothing when the mesh repeats a device).  The reference's
wrap-around hop S-1 -> 0 carries nothing stage 0 reads (it reads the
inputs), so it is dropped.  One tick loop serves both device types;
only the hand-off differs.  On CUDA each stage runs on a stream of its
own, so stages overlap on one card as well as across cards; a stage
waits for its input's event, copies it to its device on its own stream
(nothing when the device is the same), and records the input on that
stream, so the caching allocator does not hand the memory of a tensor
made on one stream and read on another out early.  On the host the
ticks run in order.  The outputs are collected from the last stage and
returned on the first stage's device (the reference's broadcast back to
all stages, for a single controller).
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from ..device import resolve_device
from .sharding import Mesh


def _stage_devices(mesh: Mesh, axis: str) -> list:
    if mesh.devices.ndim != 1 or mesh.axis_names != (axis,):
        raise ValueError(f"pipeline_apply: need a 1-d mesh over {axis!r}, "
                         f"got {mesh!r}")
    devs = mesh.flat()
    for d in devs:
        resolve_device(d)                    # a CUDA entry needs a GPU
    if devs[0].type not in ("cuda", "cpu"):
        raise ValueError(f"pipeline_apply: stages must run on cuda or cpu "
                         f"devices, got {mesh!r}")
    return devs


def pipeline_apply(stage_fn: Callable, mesh: Mesh, *, axis: str = "stage",
                   n_microbatches: int):
    """Build ``run(stage_params, x) -> y``.

    stage_fn(params_s, x_mb) -> y_mb applies one stage's layers to one
    microbatch (the same activation shape in and out: a transformer
    trunk).  ``stage_params``: a sequence of S per-stage parameters, the
    s-th on mesh entry s's device (``split_stages`` gives them from
    stacked tensors; a stage's parameters may be any object
    ``stage_fn`` takes).  ``x``: (M, mb, ...) microbatched inputs on any
    device.  Returns y: (M, mb, ...) on the first stage's device."""
    devs = _stage_devices(mesh, axis)
    S, M = len(devs), n_microbatches
    if M < 1:
        raise ValueError(f"pipeline_apply: n_microbatches={M}")

    def run(stage_params: Sequence, x: torch.Tensor) -> torch.Tensor:
        if len(stage_params) != S:
            raise ValueError(f"pipeline_apply: {len(stage_params)} stage "
                             f"parameter sets for {S} stages")
        if x.shape[0] != M:
            raise ValueError(f"pipeline_apply: x has {x.shape[0]} "
                             f"microbatches, not {M}")
        hop = (_StreamHandoff if devs[0].type == "cuda" else _Handoff)(devs)
        xs, ready = hop.inputs(x)
        held: Dict[int, tuple] = {}      # stage -> (its next input, event)
        outs = [None] * M
        for t in range(M + S - 1):
            made: Dict[int, tuple] = {}
            for s in range(S):
                m = t - s
                if not 0 <= m < M:
                    continue
                src = (xs[m], ready) if s == 0 else held[s]
                y = hop.stage(s, stage_fn, stage_params[s], src)
                if s == S - 1:
                    outs[m] = y
                else:
                    made[s + 1] = y
            held = made
        return hop.collect(outs)

    return run


class _Handoff:
    """The hand-off between stages on the host: the ticks run in order,
    so a stage's input is ready when it is read (no event)."""

    def __init__(self, devs):
        self.devs = devs

    def inputs(self, x):
        return x.to(self.devs[0]), None

    def stage(self, s, stage_fn, params, src):
        x, _ = src
        return stage_fn(params, x.to(self.devs[s])), None

    def collect(self, outs):
        return torch.stack([y.to(self.devs[0]) for y, _ in outs])


class _StreamHandoff(_Handoff):
    """The hand-off on CUDA: each stage runs on a stream of its own,
    waits for its input's event, copies the input to its device on that
    stream and records it there; its output comes with an event of its
    own."""

    def __init__(self, devs):
        super().__init__(devs)
        self.caller = torch.cuda.current_stream(devs[0])
        self.streams = [torch.cuda.Stream(device=d) for d in devs]

    def inputs(self, x):
        xs = x.to(self.devs[0], non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(self.caller)        # x is on the first stage's device
        return xs, ready

    def stage(self, s, stage_fn, params, src):
        x, ev = src
        st = self.streams[s]
        with torch.cuda.device(self.devs[s]), torch.cuda.stream(st):
            st.wait_event(ev)
            x.record_stream(st)
            y = stage_fn(params, x.to(self.devs[s], non_blocking=True))
            done = torch.cuda.Event()
            done.record(st)
        return y, done

    def collect(self, outs):
        ys = []
        for y, done in outs:             # microbatch order
            self.caller.wait_event(done)
            y.record_stream(self.caller)
            ys.append(y.to(self.devs[0], non_blocking=True))
        return torch.stack(ys)


def split_stages(stacked_params: Dict[str, torch.Tensor], n_stages: int
                 ) -> list:
    """{name: (L, ...)} stacked layer parameters -> a list of S dicts
    {name: (L/S, ...)}, stage-major (the reference's (S, L/S, ...))."""
    out = [dict() for _ in range(n_stages)]
    for name, a in stacked_params.items():
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"split_stages: {name} has {L} layers, not a "
                             f"multiple of {n_stages} stages")
        for s, part in enumerate(a.reshape((n_stages, L // n_stages)
                                           + tuple(a.shape[1:]))):
            out[s][name] = part
    return out
