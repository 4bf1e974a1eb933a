"""The readings that set the correctness check's limits.

    python3 portbench/control.py --workload <cell> --program-seeds a,b,..
        [--control-seeds x,y,z]

For each program seed: ``check.CHECKED`` campaigns of the cell, as a run
makes them (same images, same sampled lanes, over the cell's cards),
answered by the program and compared with the reference: the lower
readings.  For each control seed: the same campaigns answered by the
control -- the plain reference put in the program's place and computed
in bfloat16, the precision below the float32 the configuration states --
and compared the same way: the upper readings.  A reduced cell's control
reduces its own bfloat16 lanes with the plain front or top-k
(``reference/front.py``).  Both sides run on the configuration's array
(``rows`` x ``cols``, 4x4 unless it names another).  One JSON line a
seed.  Needs a CUDA device, as a run does.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

if __name__ == "__main__":
    _root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_root), str(_root / "src")]

from portbench import cells as _cells  # noqa: E402
from portbench import check  # noqa: E402
from portbench import images as _images  # noqa: E402
from portbench.reference import front as ref_front  # noqa: E402


def control_answers(inp: check.Inputs, seed: int, campaigns: List[int],
                    device) -> tuple:
    """(kept, samples) of ``campaigns`` answered by the bfloat16
    reference, as ``check.keep`` keeps the program's."""
    kept, samples = {}, {}
    for c in campaigns:
        samples[c] = check.sample(inp, seed, c)
        if inp.reduce is None:
            ref = check.reference_answers(inp, seed, {c: samples[c]}, device,
                                          energy_dtype=torch.bfloat16)
            kept[c] = ref[c]
            continue
        every = [np.arange(len(p) * len(inp.hw) * int(call["images"]))
                 for p, call in zip(inp.programs, inp.calls)]
        ref = check.reference_answers(inp, seed, {c: every}, device,
                                      energy_dtype=torch.bfloat16)[c]
        red = inp.reduce
        parts = []
        for call, lanes in zip(inp.calls, ref):
            block = len(inp.hw) * int(call["images"])
            parts.append(ref_front.pareto_fronts(
                lanes, block, tuple(red["axes"]), int(red["max_points"]))
                if red["kind"] == "pareto" else
                ref_front.top_k(lanes, block, int(red["k"])))
        kept[c] = parts
    return kept, samples


def program_answers(camp, inp: check.Inputs, seed: int,
                    campaigns: List[int]) -> tuple:
    kept, samples = {}, {}
    for c in campaigns:
        answer = camp.run(camp.images(seed, _images.WINDOW, c))
        samples[c] = check.sample(inp, seed, c)
        kept[c] = check.keep(inp, answer, samples[c])
    return kept, samples


def readings(cell: _cells.Cell, program_seeds: List[int],
             control_seeds: List[int], device,
             profile_fn: Optional[Callable] = None,
             emit: Callable[[dict], None] = print) -> List[dict]:
    """One dict a seed: side, seed, numbers, verdict, seconds."""
    from portbench.campaign import Campaigns
    from portbench.harness import _check_inputs
    from repro_torch.core.characterization import default_profile

    dev = torch.device(device)
    prof = (profile_fn or (lambda d: default_profile(device=d)))(dev)
    camp = Campaigns(cell.config, cell.mix, prof, dev, chips=cell.chips)
    inp = _check_inputs(camp, cell)
    camp.run(camp.images(0, _images.WARMUP, 0))
    campaigns = list(range(check.CHECKED))
    out = []
    for side, seeds in (("program", program_seeds),
                        ("control", control_seeds)):
        for seed in seeds:
            t = time.perf_counter()
            kept, samples = (program_answers(camp, inp, seed, campaigns)
                             if side == "program" else
                             control_answers(inp, seed, campaigns, dev))
            res = check.compare(inp, kept, samples, seed, dev)
            row = {"cell": cell.name, "side": side, "seed": seed,
                   "numbers": res["numbers"],
                   "correct": check.verdict(res["numbers"]),
                   "seconds": time.perf_counter() - t}
            emit(row)
            out.append(row)
    return out


def main(argv: List[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    if not torch.cuda.is_available():
        print("portbench: no CUDA device is available", file=sys.stderr)
        return 2
    cell = _cells.load_cell(args.workload)
    readings(cell, seeds(args.program_seeds), seeds(args.control_seeds),
             "cuda", emit=lambda row: print(json.dumps(row), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
