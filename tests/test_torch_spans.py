"""The port's span-and-counter recorder (``repro_torch.spans``).

It records while ``torch.profiler`` records and at no other time: a
sweep without the profiler leaves the report empty, and a sweep under it
answers bit for bit as without it.  Under the profiler every span of the
sweep path has the count its calls and buckets imply, self times add up,
the spans sit nested in the profiler's Chrome export, and the chunk
loop's counters (``_launch_rounds`` with a stand-in launcher) count
reads of ``done``, turnarounds, lane-slots and lane-steps exactly.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.analysis import pareto  # noqa: E402
from repro_torch.apps import mibench  # noqa: E402
from repro_torch.core import dse, hwconfig  # noqa: E402
from repro_torch.core.characterization import characterize  # noqa: E402
from repro_torch.kernels.cgra_sweep import ops  # noqa: E402
from repro_torch.kernels.cgra_sweep.ref import init_lanes  # noqa: E402

SPECS = [None, pareto.TopK("edp", k=3)]
IDS = ["full", "topk"]
N_BUCKETS = 2
# each span's parent in the sweep path; None: opened outside any span
PARENT = {"dse.plan": None, "dse.plan.knobs": "dse.plan",
          "dse.plan.grid": "dse.plan", "dse.plan.tables": "dse.plan.grid",
          "dse.run": None, "reduce.device": "dse.run",
          "reduce.to_host": "dse.run", "reduce.merge": "dse.run"}


@pytest.fixture(scope="module")
def prof():
    return characterize(device="cpu")


@pytest.fixture(autouse=True)
def _fresh_recorder(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    spans.reset()
    yield
    spans.reset()


def _grid(prof, device="cpu"):
    """Two programs of different lengths (two buckets), two configs,
    four images."""
    ks = [mibench.bitcnt(n_words=16), mibench.sha_mix(rounds=4)]
    images = np.stack([ks[0].mem_init, ks[1].mem_init] * 2)
    return dict(programs=[k.program for k in ks], profile=prof,
                hw_configs=[hwconfig.TOPOLOGIES[t]()
                            for t in ("baseline", "c_interleaved")],
                mem_images=images, max_steps=128,
                mem_size=images.shape[1], chunk_steps=32, blk_b=32,
                max_buckets=N_BUCKETS, device=device)


def _profiler():
    return torch.profiler.profile(activities=[ProfilerActivity.CPU])


def _fields(res):
    if isinstance(res, pareto.ReducedResult):
        return [np.asarray(x).tobytes() for x in res]
    return [x.cpu().numpy().tobytes() for x in res]


def test_the_flag_is_the_profilers():
    """The recorder reads the flag the installed PyTorch sets while a
    ``torch.profiler`` session records."""
    from torch.autograd import profiler as autograd_profiler
    assert not spans.recording()
    assert autograd_profiler._is_profiler_enabled is False
    with _profiler():
        assert spans.recording()
        assert autograd_profiler._is_profiler_enabled is True
    assert not spans.recording()


def test_no_profiler_records_nothing(prof):
    for spec in SPECS:
        dse.sweep(reduce=spec, **_grid(prof))
    with spans.span("outside"):
        spans.count("n", 3)
        spans.add_seconds("s", 1.0)
        spans.keep_lane_steps(torch.ones(4, dtype=torch.int32))
    assert spans.report() == {"spans": {}, "counts": {}, "seconds": {},
                              "lane_steps": 0}


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_profiled_sweep_is_bit_identical(prof, spec):
    want = _fields(dse.sweep(reduce=spec, **_grid(prof)))
    with _profiler():
        got = _fields(dse.sweep(reduce=spec, **_grid(prof)))
    assert got == want


def _profiled_sweeps(prof):
    """One unreduced and one top-k sweep under the profiler."""
    with _profiler() as p:
        for spec in SPECS:
            dse.sweep(reduce=spec, **_grid(prof))
    return p, spans.report()


def test_span_counts_follow_calls_and_buckets(prof):
    _, rep = _profiled_sweeps(prof)
    got = {name: s["count"] for name, s in rep["spans"].items()}
    assert got == {"dse.plan": 2, "dse.plan.knobs": 2,
                   "dse.plan.grid": 2 * N_BUCKETS,
                   "dse.plan.tables": 2 * N_BUCKETS, "dse.run": 2,
                   "reduce.device": N_BUCKETS, "reduce.to_host": N_BUCKETS,
                   "reduce.merge": 1}
    for name, s in rep["spans"].items():
        assert s["parents"] == ([] if PARENT[name] is None
                                else [PARENT[name]]), name
        assert "device_s" not in s            # nothing ran on a card
    # the plain version runs on the host: no chunk loop, nothing waits
    assert rep["counts"] == {"host_syncs": 0}
    assert rep["seconds"] == {} and rep["lane_steps"] == 0


def test_self_times_add_up(prof):
    _, rep = _profiled_sweeps(prof)
    s = rep["spans"]
    for name, entry in s.items():
        assert 0 <= entry["self_s"] <= entry["total_s"], name
    for parent in {p for p in PARENT.values() if p}:
        children = sum(e["total_s"] for n, e in s.items()
                       if PARENT[n] == parent)
        assert children <= s[parent]["total_s"], parent
        assert s[parent]["self_s"] == pytest.approx(
            s[parent]["total_s"] - children, abs=1e-9)
    # the plan's parts and its self time make its whole
    parts = (s["dse.plan.knobs"]["total_s"] + s["dse.plan.grid"]["self_s"]
             + s["dse.plan.tables"]["total_s"] + s["dse.plan"]["self_s"])
    assert parts == pytest.approx(s["dse.plan"]["total_s"], abs=1e-9)


def test_chrome_export_nests_the_spans(prof, tmp_path):
    p, rep = _profiled_sweeps(prof)
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith(spans.PREFIX)]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"][len(spans.PREFIX):], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert {n: len(v) for n, v in by_name.items()} == {
        n: s["count"] for n, s in rep["spans"].items()}
    for name, parent in PARENT.items():
        if parent is None:
            continue
        for a, b in by_name[name]:
            assert any(pa <= a and b <= pb for pa, pb in by_name[parent]), \
                (name, parent)


def test_mesh_sweep_spans(prof):
    """A top-k sweep over two host shards: a device reduction and a copy
    to the host a shard and bucket, a merge a bucket and one for the
    call; the answer bit for bit as without the profiler."""
    from repro_torch.launch.mesh import make_debug_mesh
    kw = dict(_grid(prof), device=None, reduce=pareto.TopK("edp", k=3),
              mesh=make_debug_mesh(2, device="cpu"))
    want = _fields(dse.sweep(**kw))
    with _profiler():
        got = _fields(dse.sweep(**kw))
    assert got == want
    s = spans.report()["spans"]
    assert {n: e["count"] for n, e in s.items()} == {
        "dse.plan": 1, "dse.plan.knobs": 1, "dse.plan.grid": N_BUCKETS,
        "dse.plan.tables": N_BUCKETS, "dse.run": 1,
        "reduce.device": 2 * N_BUCKETS, "reduce.to_host": 2 * N_BUCKETS,
        "reduce.merge": N_BUCKETS + 1}
    for name, e in s.items():
        assert e["parents"] == ([] if PARENT[name] is None
                                else [PARENT[name]]), name


def _fake_launcher(finish_at):
    """A stand-in for ``_chunk_launcher``: lane ``j`` of a shard exits
    after ``finish_at[shard][j]`` steps."""
    calls = []

    def make(tables, hw, gidx, st, *, rows, cols, max_steps, k_steps, blk_b):
        ends = torch.as_tensor(finish_at[len(calls)], dtype=torch.int32)
        calls.append(st)

        def launch(t0):
            end = min(t0 + k_steps, max_steps)
            st.n_exec.copy_(torch.clamp(ends, max=end))
            st.done.copy_((ends <= end).to(torch.int32))
        return launch
    return make


@pytest.mark.parametrize("finish_at, launches, reads", [
    ([[17, 20, 24, 19, 23]], [3], 4),
    ([[9, 16], [17, 20, 24]], [2, 3], 2 + 2 + 2 + 1),
], ids=["one-shard", "two-shards"])
def test_chunk_loop_counters(monkeypatch, finish_at, launches, reads):
    K = 8
    monkeypatch.setattr(ops, "_chunk_launcher", _fake_launcher(finish_at))
    states = [init_lanes(torch.zeros((len(f), 4), dtype=torch.int32), 16)
              for f in finish_at]
    with _profiler():
        counts = ops._launch_rounds([(None, None, None, st)
                                     for st in states], rows=4, cols=4,
                                    max_steps=100, chunk_steps=K, blk_b=32)
    assert counts == launches
    rep = spans.report()
    slots = sum(n * len(f) * K for n, f in zip(launches, finish_at))
    steps = sum(sum(f) for f in finish_at)
    assert rep["counts"] == {"host_syncs": reads, "sweep.lane_slots": slots}
    assert rep["seconds"]["sweep.turnaround"]["count"] == max(launches)
    assert rep["seconds"]["sweep.turnaround"]["total_s"] >= 0
    assert rep["lane_steps"] == steps
    assert rep["spans"]["sweep.chunk_loop"]["count"] == 1
    assert 0 < 100.0 * steps / slots <= 100.0


def test_chunk_loop_slots_stop_at_max_steps(monkeypatch):
    """A last chunk cut by ``max_steps`` launches only the steps left."""
    monkeypatch.setattr(ops, "_chunk_launcher",
                        _fake_launcher([[50, 50, 50]]))
    st = init_lanes(torch.zeros((3, 4), dtype=torch.int32), 16)
    with _profiler():
        counts = ops._launch_rounds([(None, None, None, st)], rows=4,
                                    cols=4, max_steps=20, chunk_steps=8,
                                    blk_b=32)
    assert counts == [3]                       # steps 0-7, 8-15, 16-19
    rep = spans.report()
    assert rep["counts"] == {"host_syncs": 3, "sweep.lane_slots": 3 * 20}
    assert rep["lane_steps"] == 3 * 20


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_recorder_on_the_card(prof, spec):
    """On the card: bit for bit as without the profiler, every host sync
    counted (a read of ``done`` a launch and one a bucket, the bank
    check, the tables' five copies to the card, a reduced part's eight
    fields; the lane operands' one upload a bucket does not wait),
    lane-slots of every launch, and the reducer timed on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = _grid(prof, device="cuda")
    want = _fields(dse.sweep(reduce=spec, **kw))
    before = ops.sweep_engine.launches
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]):
        got = _fields(dse.sweep(reduce=spec, **kw))
    launches = ops.sweep_engine.launches - before
    assert got == want
    rep = spans.report()
    per_bucket = 1 + 1 + 5
    if spec is not None:
        per_bucket += len(pareto.ReducedResult._fields)
        assert rep["spans"]["reduce.device"]["device_s"] > 0
    assert rep["counts"]["host_syncs"] == launches + N_BUCKETS * per_bucket
    assert rep["spans"]["sweep.chunk_loop"]["count"] == N_BUCKETS
    assert rep["seconds"]["sweep.turnaround"]["count"] == launches
    assert rep["counts"]["sweep.lane_slots"] % 32 == 0
    assert 0 < rep["lane_steps"] <= rep["counts"]["sweep.lane_slots"]
