"""The benchmark finds its pieces by name, keeps to its contract's shape,
and imports neither JAX nor the JAX package."""
import json
import subprocess
import sys
import textwrap

import pytest

from portbench.conftest import ROOT, make_tree, tiny_config
from portbench import cells
from portbench.harness import Readings

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(workload):
    cell = cells.load_cell(workload)
    assert cell.config["calls"] and cell.chips in (1, 4)
    assert {m["name"] for m in cell.end_to_end} >= {
        "design_points_per_s", "campaign_p95_ms", "setup_s"}
    readers = cells.metric_readers(cell)
    assert set(readers) == {m["name"] for m in cell.per_layer}


def test_added_files_are_found_by_name(tmp_path):
    """A configuration, a mix and a metric added as new files, with new
    entries in BENCHMARK.json, are found without editing any file."""
    root = make_tree(tmp_path, {"extra": tiny_config()})
    bench = root / "portbench"
    (bench / "mixes" / "topk2.json").write_text(json.dumps(
        {"name": "topk2", "reduce": {"kind": "topk", "objective": "edp",
                                     "k": 2}}))
    (bench / "metrics" / "campaigns_traced.py").write_text(textwrap.dedent(
        """
        def read(r):
            return float(r.campaigns)
        """))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "extra.topk2", "config": "extra",
                              "traffic": "topk2", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "campaigns_traced", "unit": "n",
                              "better": "higher", "source": "host_clock",
                              "layer": "whole campaign",
                              "moves": "design_points_per_s",
                              "workloads": ["extra.topk2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.load_cell("extra.topk2", root=root)
    assert cell.config["name"] == "tiny"
    assert cell.mix["reduce"]["k"] == 2
    readers = cells.metric_readers(cell, bench)
    r = Readings(wall_s=[0.1, 0.2], plan_s=[], launches=[], answer_bytes=[],
                 least_s=[], trace=None, peak_bytes=0)
    assert readers["campaigns_traced"](r) == 2.0
    with pytest.raises(KeyError):
        cells.load_cell("extra.none", root=root)


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    cell_names = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cell_names)) <= cell_names
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and len(c["source"]) <= 200
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_no_jax_or_jax_package_is_imported():
    """Every module of the benchmark, and what it loads of the program,
    leaves no top-level ``jax``, ``jaxlib``, ``flax`` or ``repro``."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        import portbench.harness, portbench.campaign, portbench.check
        import portbench.control, portbench.tracing, portbench.reference.conv
        import portbench.reference.mibench, portbench.reference.front
        import portbench.reference.profile
        import repro_torch.core.dse, repro_torch.core.characterization
        import repro_torch.kernels.cgra_sweep.ops
        from portbench import cells
        for w in {sorted(w['name'] for w in SPEC['workloads'])!r}:
            cells.metric_readers(cells.load_cell(w))
        bad = {{m.split('.')[0] for m in sys.modules}} & {{'jax', 'jaxlib',
                                                          'flax', 'repro'}}
        print(sorted(bad))
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_the_program(tmp_path):
    """In a tree holding only BENCHMARK.json and the benchmark's folder,
    a run exits non-zero and prints no result."""
    root = make_tree(tmp_path, {})
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "conv-study.full", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
