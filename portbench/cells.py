"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the repository's root names each cell's
configuration and traffic mix.  A configuration is the JSON file its
entry in ``configs`` names; a traffic mix is ``mixes/<traffic>.json``
beside this file; a per-layer metric is ``metrics/<name>.py``, a module
with ``read(readings) -> float | None``.  Adding a cell, a
configuration, a mix or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT,
              bench: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; mixes are read
    from ``bench`` (default: beside this file, or ``root/<bench name>``
    when ``root`` is another tree)."""
    root = Path(root)
    bench = Path(bench) if bench is not None else (
        BENCH if root.resolve() == ROOT else root / BENCH.name)
    spec = load_benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}"
                       f"; it has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((bench / "mixes" / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, workload)])


def metric_reader(name: str, bench: Path = BENCH) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = Path(bench) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_readers(cell: Cell, bench: Path = BENCH) -> Dict[str, Callable]:
    return {m["name"]: metric_reader(m["name"], bench)
            for m in cell.per_layer}
