"""The readers of the program's own spans and counters
(``program_spans.py`` and eleven ``metrics/`` files): each reads the
recorder's report a campaign, and gives nothing where the program has no
recorder or the report lacks what it reads."""
import copy
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from portbench import cells, harness
from portbench.conftest import ROOT

READERS = ["plan_span_ms", "plan_knobs_ms", "plan_grid_ms",
           "plan_tables_ms", "run_self_ms", "chunk_turnaround_ms",
           "chunk_fill", "host_syncs", "reduce_device_ms",
           "reduce_to_host_ms", "merge_ms"]
CAMPAIGNS = 3


def _expected(rep: dict, name: str) -> float:
    """The reader ``name``'s value, from the report by hand."""
    s, c = rep["spans"], CAMPAIGNS
    ms = lambda span, key="total_s": s[span][key] / c * 1e3
    return {"plan_span_ms": lambda: ms("dse.plan"),
            "plan_knobs_ms": lambda: ms("dse.plan.knobs"),
            "plan_grid_ms": lambda: ms("dse.plan.grid", "self_s"),
            "plan_tables_ms": lambda: ms("dse.plan.tables"),
            "run_self_ms": lambda: ms("dse.run", "self_s"),
            "chunk_turnaround_ms": lambda:
                rep["seconds"]["sweep.turnaround"]["total_s"] / c * 1e3,
            "chunk_fill": lambda: 100.0 * rep["lane_steps"]
                / rep["counts"]["sweep.lane_slots"],
            "host_syncs": lambda: rep["counts"]["host_syncs"] / c,
            "reduce_device_ms": lambda: ms("reduce.device", "device_s"),
            "reduce_to_host_ms": lambda: ms("reduce.to_host"),
            "merge_ms": lambda: ms("reduce.merge")}[name]()


def _readings() -> harness.Readings:
    return harness.Readings(wall_s=[0.1] * CAMPAIGNS, plan_s=[],
                            launches=[], answer_bytes=[], least_s=[],
                            trace=None, peak_bytes=0)


@pytest.fixture
def recorder(tmp_path, monkeypatch):
    from repro_torch import spans
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    spans.reset()
    yield spans
    spans.reset()


@pytest.fixture(scope="module")
def filled(tmp_path_factory):
    """The report of a tiny CPU sweep, reduced and not, under the
    profiler, and of a chunk loop of three chunks with a stand-in
    launcher (four lanes of 15 steps in chunks of 32)."""
    from repro_torch import spans
    from repro_torch.analysis import pareto
    from repro_torch.apps import mibench
    from repro_torch.core import dse, hwconfig
    from repro_torch.core.characterization import characterize
    from repro_torch.kernels.cgra_sweep import ops
    from repro_torch.kernels.cgra_sweep.ref import init_lanes

    prof = characterize(device="cpu")
    ks = [mibench.bitcnt(n_words=16), mibench.sha_mix(rounds=4)]
    images = np.stack([k.mem_init for k in ks])
    kw = dict(programs=[k.program for k in ks], profile=prof,
              hw_configs=[hwconfig.TOPOLOGIES["baseline"]()],
              mem_images=images, max_steps=128, mem_size=images.shape[1],
              chunk_steps=32, blk_b=32, max_buckets=2, device="cpu")

    def launcher(tables, hw, gidx, st, **knobs):
        def launch(t0):
            st.n_exec.add_(5)
            st.done.fill_(int(st.n_exec[0]) >= 15)
        return launch

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "cache.json"))
        mp.setattr(ops, "_chunk_launcher", launcher)
        spans.reset()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
            dse.sweep(**kw)
            dse.sweep(reduce=pareto.TopK("edp", 2), **kw)
            st = init_lanes(torch.zeros((4, 8), dtype=torch.int32), 16)
            ops._launch_rounds([(None, None, None, st)], rows=4, cols=4,
                               max_steps=128, chunk_steps=32, blk_b=32)
        rep = spans.report()
        spans.reset()
    return rep


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_report(recorder, filled, name, monkeypatch):
    rep = copy.deepcopy(filled)
    monkeypatch.setattr(recorder, "report", lambda: rep)
    read = cells.metric_reader(name)
    if name == "reduce_device_ms":       # no card: no device time
        assert read(_readings()) is None
        rep["spans"]["reduce.device"]["device_s"] = 0.004
    assert read(_readings()) == pytest.approx(_expected(rep, name),
                                              rel=1e-12)
    if name == "chunk_fill":
        assert read(_readings()) == pytest.approx(100.0 * 4 * 15
                                                  / (3 * 4 * 32))


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_nothing_without_the_recorder(recorder, name,
                                                   monkeypatch):
    """An empty report (nothing recorded), and a program without the
    recorder (an older checkout), give ``None``."""
    read = cells.metric_reader(name)
    assert read(_readings()) is None
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read(_readings()) is None


@pytest.mark.cuda
def test_tiny_traced_cell_on_the_card(tiny_tree):
    """A traced tiny top-k cell on the card gives every new metric; the
    program's plan span reads within 10% (or 1 ms) of the harness's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import spans
    from repro_torch.core.characterization import characterize
    spans.reset()
    cell = cells.load_cell("tiny.topk", root=tiny_tree)
    readers = {n: cells.metric_reader(n, ROOT / "portbench")
               for n in READERS + ["plan_ms", "sweep_launches"]}
    out = harness.run_cell(cell, seed=2**31 + 5, seconds=0.01, trace=True,
                           device="cuda", t_start=time.perf_counter(),
                           workdir=tiny_tree,
                           profile_fn=lambda d: characterize(device=d),
                           readers=readers)
    assert out["correct"], out["numbers"]
    m = out["metrics"]
    assert set(READERS) <= set(m)
    assert abs(m["plan_span_ms"] - m["plan_ms"]) <= max(
        0.1 * m["plan_ms"], 1.0)
    assert 0 < m["chunk_fill"] <= 100
    # a read of done after every launch and once more a call
    assert m["host_syncs"] > m["sweep_launches"]
    spans.reset()
