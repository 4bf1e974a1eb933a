"""Fixtures of the benchmark's own CPU tests: a copy of the benchmark's
tree with tiny cells added, as a later change would add them."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


def tiny_config() -> dict:
    """One short sha_mix call on eight images under two hardware configs."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "mibench-fig2.json")
                     .read_text())
    cfg["name"] = "tiny"
    cfg["hardware"] = {"topologies": ["baseline", "d_dma_per_pe"],
                       "smul_lat": [3], "n_banks": [4]}
    call = cfg["calls"][-1]
    call["programs"][0]["args"] = {"rounds": 1}
    call["images"] = 8
    cfg["calls"] = [call]
    return cfg


def probe_config(rows: int, cols: int) -> dict:
    """``tiny_config`` on a ``rows`` x ``cols`` array: two seeded probe
    kernels of ``reference/probe.py`` on eight images under two
    topologies of several banks and one DMA engine a column."""
    cfg = tiny_config()
    cfg.update(name=f"probe{rows}x{cols}", rows=rows, cols=cols,
               hardware={"topologies": ["b_n_to_m", "c_interleaved"],
                         "smul_lat": [3], "n_banks": [4]})
    call = cfg["calls"][0]
    call["programs"] = [{"module": "probe", "kernel": "probe",
                         "args": {"rows": rows, "cols": cols, "seed": s}}
                        for s in (1, 2)]
    call["max_steps"] = 64
    return cfg


def make_tree(tmp: Path, configs: dict) -> Path:
    """``tmp`` holding BENCHMARK.json and the benchmark's folder, with
    ``configs`` (name -> config dict) added and a cell of each under every
    mix; the existing files are copied, none edited."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in configs.items():
        path = f"portbench/configs/{name}.json"
        (tmp / path).write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test",
                                "file": path, "reduced": [], "why": "test"})
        for mix in sorted((tmp / "portbench" / "mixes").glob("*.json")):
            spec["workloads"].append({"name": f"{name}.{mix.stem}",
                                      "config": name, "traffic": mix.stem,
                                      "chips": 1, "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def tiny_tree(tmp_path):
    return make_tree(tmp_path, {"tiny": tiny_config()})
