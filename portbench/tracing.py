"""The traced run: spans from the benchmark's own calls, and the device
trace of ``torch.profiler``.

Spans are ``torch.profiler.record_function`` ranges named
``portbench.<layer>``: the harness opens them around its calls into
the program (the plan, the sweep, the copy to the host) and, for the
traced window only, around two of the program's own functions it calls
through (``instrument``): the chunk loop (``dse.sweep_engine``) and the
host merge of reduced parts (``pareto.merge_reduced``), plus the
scatter back to canonical order (``dse._scatter``) and the copy of a
reduced part to the host (``pareto._as_numpy``).  Nothing in the
program changes; the originals are put back when the window closes.

The trace is read from its Chrome export: device operations (kernels,
copies, sets) by name, time and card (a device event's ``pid`` is its
card), each card's busy time as the union of its operations' intervals
inside the window, and each card's idle gaps between them, labelled by
the innermost span the host was in at the gap's middle.  A cell over
several cards reads the mean card's busy time, the time in which every
card is busy at once, and the idle gaps and operations summed over its
cards; with one card these are that card's.
"""
from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "portbench."


def span(name: str):
    import torch
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def instrument():
    """Spans around the program's chunk loop (one lane set's, or a mesh's
    shards'), scatter, copy of reduced parts to the host and merge, for
    the life of the context."""
    from repro_torch.analysis import pareto
    from repro_torch.core import dse

    patched = [(dse, "sweep_engine", "chunk_loop"),
               (dse, "sweep_shards", "chunk_loop"),      # a mesh's shards
               (dse, "_scatter", "scatter"),
               (pareto, "_as_numpy", "to_host"),
               (pareto, "merge_reduced", "merge")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patched]

    def wrap(fn, label):
        def wrapped(*args, **kw):
            with span(label):
                return fn(*args, **kw)
        return wrapped

    for (mod, attr, label), (_, _, fn) in zip(patched, saved):
        setattr(mod, attr, wrap(fn, label))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def profile():
    import torch
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])


class Trace:
    """The parsed device trace of one traced window over ``cards`` cards:
    ``ops`` are ``(name, start_us, end_us, card)``."""

    def __init__(self, prof, workdir: Path, cards: int = 1):
        path = Path(workdir) / "trace.json"
        prof.export_chrome_trace(str(path))
        try:
            events = json.loads(path.read_text())["traceEvents"]
        finally:
            os.unlink(path)
        spans = [e for e in events if e.get("ph") == "X"
                 and str(e.get("name", "")).startswith(PREFIX)
                 and e.get("cat") == "user_annotation"]
        window = [e for e in spans if e["name"] == PREFIX + "window"]
        if len(window) != 1:
            raise RuntimeError("the trace holds no single window span")
        self.t0 = float(window[0]["ts"])
        self.t1 = self.t0 + float(window[0]["dur"])
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"][len(PREFIX):]) for e in spans
                      if e is not window[0]]
        self.ops = [(str(e["name"]), float(e["ts"]),
                     float(e["ts"]) + float(e.get("dur", 0.0)), e.get("pid"))
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") in DEVICE_CATS
                    and self.t0 <= float(e["ts"]) <= self.t1]
        by: Dict[object, list] = defaultdict(list)
        for op in self.ops:
            by[op[3]].append(op)
        # a card of the cell that ran nothing in the window is idle in all
        # of it
        self.card_ops = [by[c] for c in sorted(by, key=str)] + [
            []] * max(0, cards - len(by))
        self.card_busy_s = [self._union(ops) * 1e-6
                            for ops in self.card_ops]
        self.busy_s = sum(self.card_busy_s) / len(self.card_ops)
        self.all_busy_s = self._all_busy() * 1e-6

    def _union(self, ops) -> float:
        total, end = 0.0, None
        for _, s, e, _ in sorted(ops, key=lambda o: o[1]):
            e = min(e, self.t1)
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def _merged(self, ops) -> List[tuple]:
        """A card's busy intervals, merged and clipped to the window."""
        out: List[list] = []
        for _, s, e, _ in sorted(ops, key=lambda o: o[1]):
            e = min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(iv) for iv in out]

    def _all_busy(self) -> float:
        """Microseconds of the window in which every card runs an
        operation."""
        edges = sorted((t, d) for ops in self.card_ops
                       for s, e in self._merged(ops)
                       for t, d in ((s, 1), (e, -1)))
        total, busy, since = 0.0, 0, 0.0
        for t, d in edges:
            if busy == len(self.card_ops):
                total += t - since
            busy += d
            since = t
        return total

    def device_seconds(self, match=lambda name: True) -> float:
        return sum(e - s for name, s, e, _ in self.ops
                   if match(name)) * 1e-6

    def top_ops(self, n: int = 10) -> List[list]:
        """Device seconds by operation name, summed over the cards."""
        by: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.ops:
            by[name] += (e - s) * 1e-6
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_span(self, t: float) -> str:
        inner = [(e - s, name) for s, e, name in self.spans if s <= t <= e]
        return min(inner)[1] if inner else "between calls"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle card time inside the window by the host's span, summed
        over the cards."""
        by: Dict[str, float] = defaultdict(float)
        for ops in self.card_ops:
            t = self.t0
            for _, s, e, _ in sorted(ops, key=lambda o: o[1]) + [
                    ("", self.t1, self.t1, None)]:
                if s > t:
                    by[self._host_span((s + t) / 2)] += (s - t) * 1e-6
                t = max(t, min(e, self.t1))
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]
