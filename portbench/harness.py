"""One run of one cell: set-up, the measured window, the check.

The window is a closed loop of one client: campaign after campaign, each
waiting for the one before, each on images no earlier campaign swept,
each timed on the host from its first call to its answer on the host.
``--trace 0`` measures the end-to-end metrics over ``--seconds``;
``--trace 1`` profiles ``TRACE_CAMPAIGNS`` campaigns instead and reads
the per-layer metrics (``metrics/<name>.py``) from that trace, the
benchmark's spans and the program's counters.

A cell of ``chips`` > 1 cards runs every call over a mesh of the first
``chips`` visible cards (``campaign.Campaigns``); the harness waits on,
resets and reads the peak memory of each of them, and the trace reads
each card (``tracing.Trace``).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import cells as _cells
from . import check
from . import images as _images
from . import peaks

WARMUP_CAMPAIGNS = 2
TRACE_CAMPAIGNS = 6
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Readings:
    """What the per-layer metric readers read."""
    wall_s: List[float]          # per traced campaign
    plan_s: List[float]          # per traced campaign, all its calls
    launches: List[int]          # sweep kernel launches a campaign
    answer_bytes: List[int]
    least_s: List[float]         # the least time of each campaign's work
    #                              on the cell's cards
    trace: object                # tracing.Trace
    peak_bytes: int              # the fullest card's
    chips: int = 1               # the cell's cards

    @property
    def campaigns(self) -> int:
        return len(self.wall_s)

    def campaign_device_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the operations named by ``match`` inside the
        campaigns' spans."""
        spans = [(s, e) for s, e, name in self.trace.spans
                 if name == "campaign"]
        return sum(e - s for name, s, e, _ in self.trace.ops if match(name)
                   and any(a <= s <= b for a, b in spans)) * 1e-6


def is_sweep_kernel(name: str) -> bool:
    return "sweep_kernel" in name


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _cards(dev, chips: int) -> list:
    """The cell's cards: the first ``chips`` CUDA devices; none on the
    host."""
    import torch
    if dev.type != "cuda":
        return []
    return [torch.device("cuda", i) for i in range(chips)]


def _sync(devices: list) -> None:
    import torch
    for d in devices:
        torch.cuda.synchronize(d)


def _check_inputs(camp, cell) -> check.Inputs:
    return check.Inputs(calls=camp.calls, programs=camp.ref_programs,
                        hw=camp.hw, mem_size=camp.mem_size,
                        reduce=cell.mix.get("reduce"), rows=camp.rows,
                        cols=camp.cols)


def run_cell(cell: _cells.Cell, *, seed: int, seconds: float, trace: bool,
             device, t_start: float, workdir: Path,
             profile_fn: Optional[Callable] = None,
             readers: Optional[Dict[str, Callable]] = None) -> dict:
    """Set up, measure, check; the result's fields.  ``profile_fn(dev)``
    gives the program's characterization profile (default: its cached
    ``default_profile``)."""
    import torch

    from .campaign import Campaigns
    from repro_torch.core.characterization import default_profile
    from repro_torch.kernels.cgra_sweep.ops import sweep_engine

    dev = torch.device(device)
    devices = _cards(dev, cell.chips)
    phases = {"imports": time.perf_counter() - t_start}
    prof = (profile_fn or (lambda d: default_profile(device=d)))(dev)
    phases["profile"] = time.perf_counter() - t_start
    camp = Campaigns(cell.config, cell.mix, prof, dev, chips=cell.chips)
    inp = _check_inputs(camp, cell)
    phases["programs"] = time.perf_counter() - t_start
    for w in range(WARMUP_CAMPAIGNS):
        camp.run(camp.images(seed, _images.WARMUP, w))
        _sync(devices)
        phases[f"warm-up {w}"] = time.perf_counter() - t_start
    if trace:
        from . import tracing
        with tracing.profile():            # the profiler's own start-up
            torch.zeros(1, device=dev).add_(1)
            _sync(devices)
        readers = readers or _cells.metric_readers(cell)
        phases["profiler"] = time.perf_counter() - t_start
    # the set-up's objects stay alive for the run: the collector need not
    # walk them again inside the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    walls, plans, launches, nbytes = [], [], [], []
    kept, samples = {}, {}
    failed = 0

    def one(c: int, runner) -> None:
        nonlocal failed
        imgs = camp.images(seed, _images.WINDOW, c)
        _sync(devices)
        n0 = sweep_engine.launches
        t0 = time.perf_counter()
        answer = runner(imgs)
        walls.append(time.perf_counter() - t0)
        launches.append(sweep_engine.launches - n0)
        nbytes.append(camp.answer_bytes(answer))
        if not camp.well_formed(answer):
            failed += camp.points
        samples[c] = check.sample(inp, seed, c)
        kept[c] = check.keep(inp, answer, samples[c])

    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    parsed = None
    if not trace:
        t_w0 = time.perf_counter()
        c = 0
        while True:
            one(c, camp.run)
            c += 1
            if time.perf_counter() - t_w0 >= seconds:
                break
        window_s = time.perf_counter() - t_w0
    else:
        from . import tracing
        with tracing.profile() as p, tracing.instrument():
            with tracing.span("window"):
                for c in range(TRACE_CAMPAIGNS):
                    plan_s: List[float] = []

                    def split(imgs, plan_s=plan_s):
                        with tracing.span("campaign"):
                            return camp.run_split(imgs, tracing.span,
                                                  plan_s)

                    one(c, split)
                    plans.append(sum(plan_s))
                _sync(devices)
        parsed = tracing.Trace(p, workdir, cell.chips)
        window_s = parsed.window_s
    card_peaks = [int(torch.cuda.max_memory_allocated(d)) for d in devices]
    peak = max(card_peaks, default=0)
    n = len(walls)
    found = forbidden_modules()

    del camp
    if dev.type == "cuda":
        torch.cuda.empty_cache()            # every card's cached blocks
    chosen = sorted(kept) if trace else check.checked_campaigns(n, seed)
    res = check.compare(inp, {c: kept[c] for c in chosen},
                        {c: samples[c] for c in chosen}, seed, dev)
    numbers = res["numbers"]
    points = n * sum(len(p) * len(inp.hw) * int(call["images"])
                     for p, call in zip(inp.programs, inp.calls))
    # a forbidden module ends the run in ``main``, before any result
    out = {"correct": check.verdict(numbers) and failed == 0,
           "attempted": points, "failed": failed, "forbidden": found,
           "numbers": numbers, "checked_lanes": res["lanes"],
           "setup_s": setup_s, "window_s": window_s, "campaigns": n,
           "peak_bytes": peak, "card_peak_bytes": card_peaks,
           "setup_phases": phases,
           "p50_ms": float(np.median(walls)) * 1e3,
           "front_points": _front_points(kept, inp)}
    if not trace:
        out["metrics"] = {
            "design_points_per_s": points / window_s,
            "campaign_p95_ms": float(np.percentile(walls, 95)) * 1e3,
            "setup_s": setup_s}
        return out
    lanes = [len(p) * len(inp.hw) * int(call["images"])
             for p, call in zip(inp.programs, inp.calls)]
    least = [peaks.least_seconds(res["lane_steps"][c], sum(lanes),
                                 inp.mem_size, chips=cell.chips,
                                 pes=inp.rows * inp.cols)
             for c in range(n)]
    readings = Readings(wall_s=walls, plan_s=plans, launches=launches,
                        answer_bytes=nbytes, least_s=least, trace=parsed,
                        peak_bytes=peak, chips=cell.chips)
    values = {name: read(readings) for name, read in readers.items()}
    out["metrics"] = {k: v for k, v in values.items() if v is not None}
    out["busy_s"] = parsed.busy_s
    out["card_busy_s"] = parsed.card_busy_s
    out["breakdown"] = {"device_ops": parsed.top_ops(),
                        "idle_gaps": parsed.idle_gaps()}
    return out


def _front_points(kept: dict, inp: check.Inputs) -> int:
    """The most candidates a program of a reduced answer held, the
    dropped ones included (0 for an unreduced cell)."""
    if inp.reduce is None:
        return 0
    return max(int((np.asarray(p.count) + np.asarray(p.clipped)).max())
               for parts in kept.values() for p in parts)


def smi_line() -> str:
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        return "nvidia-smi: " + subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: not read ({e})"


def result_line(cell: _cells.Cell, out: dict, device_name: str,
                trace: bool) -> dict:
    """The last line of standard output; ``check`` comes last."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    dev = {"platform": "gpu", "kind": device_name, "count": cell.chips,
           "memory_peak_bytes": out["peak_bytes"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in out["metrics"].items() if k in units},
            "device": dev}
    if trace:
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = out["window_s"]
        line["breakdown"] = out["breakdown"]
    line["check"] = {k: {"value": v, "limit": check.LIMITS[k]}
                     for k, v in out["numbers"].items()}
    return line


def main(argv: List[str], t_start: float, workdir: Path) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = _cells.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda", t_start=t_start,
                   workdir=workdir)
    if out["forbidden"]:
        print(f"portbench: the process loaded {out['forbidden']}",
              file=sys.stderr)
        return 3
    print(smi_line())
    print(f"portbench: {cell.name} seed {args.seed}: {out['campaigns']} "
          f"campaigns in {out['window_s']:.3f} s, set-up "
          f"{out['setup_s']:.3f} s (at the end of each phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["setup_phases"].items())
          + f"), {out['checked_lanes']} lanes checked, largest reduced set "
          f"{out['front_points']}, window campaigns p50 "
          f"{out['p50_ms']:.3f} ms")
    busy = out.get("card_busy_s") or [None] * cell.chips
    print("portbench: by card: " + "; ".join(
        f"cuda:{i} peak {b} bytes" + ("" if s is None else f", busy {s!r} s")
        for i, (b, s) in enumerate(zip(out["card_peak_bytes"], busy))))
    line = result_line(cell, out, torch.cuda.get_device_name(0),
                       bool(args.trace))
    for k, v in line["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
