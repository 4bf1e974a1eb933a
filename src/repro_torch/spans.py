"""Spans and counters of the sweep path, recorded while ``torch.profiler``
records and at no other time.

The recorder has no switch of its own: it reads the profiler's enabled
flag (``torch.autograd.profiler._is_profiler_enabled``).  A sweep run
under ``torch.profiler.profile()`` records; any other run costs one flag
read at each site.

- ``span(name)`` times a host interval with ``time.perf_counter`` and
  notes the span it opened in (a stack a thread).  It keeps, by name,
  the count, the total seconds and the self seconds (the total less what
  its direct child spans cover).  It also opens
  ``torch.profiler.record_function("repro_torch." + name)``, so the span
  sits in the profiler's trace beside the card's kernels, on one clock.
  With ``device`` (a CUDA device) it records a CUDA event on that
  device's current stream at each end; the events' elapsed time is read
  only by ``report()``.
- ``count(name, n)`` adds to a counter; ``add_seconds(name, s)`` adds a
  host interval that is not a span.
- ``keep_lane_steps(n_exec)`` keeps a reference to a finished lane set's
  executed steps, summed only by ``report()``.

So recording adds no device operation and no host sync to the recorded
run.  ``report()`` returns everything as plain numbers; ``reset()``
clears it.

The sweep path's names:

- ``dse.plan``: all of ``dse.make_bucketed_sweep_fn``; inside it
  ``dse.plan.knobs`` (the knobs' resolution), ``dse.plan.grid`` (each
  bucket's grid plan and its lane operands put on the device) and, inside
  that, ``dse.plan.tables`` (``dse.sweep_tables``).
- ``dse.run``: each call of a plan's ``fn()``; inside it
  ``sweep.chunk_loop`` (``_launch_rounds``), ``reduce.device`` (a device
  reducer's call), ``reduce.to_host`` (a reduced part's copy to the host)
  and ``reduce.merge`` (the host's remap and merge of reduced parts).
- ``sweep.turnaround`` (seconds): from the return of a round's reads of
  ``done`` that found lanes still running to the return of that round's
  last launch.
- ``sweep.lane_slots`` (counter): lanes times steps of every launched
  chunk; with ``report()["lane_steps"]``, the executed steps of those
  lanes, it gives the chunks' fill.
- ``host_syncs`` (counter): each point where the sweep path waits for
  the device to hand the host a value or take one from it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."

_lock = threading.Lock()
_local = threading.local()
_spans: Dict[str, list] = {}     # name -> [count, total_s, self_s, parents]
_events: List[tuple] = []        # (name, start event, end event)
_counts: Dict[str, int] = {}
_seconds: Dict[str, list] = {}   # name -> [count, total_s]
_lane_steps: List[torch.Tensor] = []


def recording() -> bool:
    """True while a ``torch.profiler`` session records."""
    return _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "range", "stream", "start", "t0", "child", "parent")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name = name
        self.range = torch.profiler.record_function(PREFIX + name)
        self.stream = (torch.cuda.current_stream(device)
                       if device is not None and device.type == "cuda"
                       else None)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.range.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.child = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
        self.range.__exit__(*exc)
        _local.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child += dur
        with _lock:
            agg = _spans.get(self.name)
            if agg is None:
                agg = _spans[self.name] = [0, 0.0, 0.0, set()]
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - self.child
            if parent is not None:
                agg[3].add(parent.name)
            if self.stream is not None:
                _events.append((self.name, self.start, end))
        return False


def span(name: str, *, device: Optional[torch.device] = None):
    """A context that records the span ``name`` while the profiler
    records; ``device``: a CUDA device whose current stream the span
    also times."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def add_seconds(name: str, s: float) -> None:
    """Add a host interval of ``s`` seconds to ``name``."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        agg = _seconds.setdefault(name, [0, 0.0])
        agg[0] += 1
        agg[1] += s


def keep_lane_steps(n_exec: torch.Tensor) -> None:
    """Keep a finished lane set's ``(B,)`` executed steps for ``report``."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _lane_steps.append(n_exec)


def report() -> dict:
    """Everything recorded since the last ``reset``, as plain numbers:
    ``spans`` (name -> count, total_s, self_s, the names of the spans it
    opened in, and ``device_s`` for a span timed on the device),
    ``counts``, ``seconds`` (name -> count, total_s) and ``lane_steps``.
    Waits for the device where a span's events or kept steps need it."""
    with _lock:
        spans = {name: {"count": c, "total_s": t, "self_s": s,
                        "parents": sorted(p)}
                 for name, (c, t, s, p) in _spans.items()}
        events = list(_events)
        kept = list(_lane_steps)
        counts = dict(_counts)
        seconds = {name: {"count": c, "total_s": s}
                   for name, (c, s) in _seconds.items()}
    for name, start, end in events:
        end.synchronize()
        entry = spans[name]
        entry["device_s"] = (entry.get("device_s", 0.0)
                             + start.elapsed_time(end) * 1e-3)
    return {"spans": spans, "counts": counts, "seconds": seconds,
            "lane_steps": sum(int(t.sum()) for t in kept)}


def reset() -> None:
    """Forget everything recorded."""
    with _lock:
        _spans.clear()
        _events.clear()
        _counts.clear()
        _seconds.clear()
        _lane_steps.clear()
