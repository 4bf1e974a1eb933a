"""A cell over several cards: the trace read card by card, the least time
split over the cards, and a campaign over a mesh, on the host.

A one-card trace reads exactly what the reader read before it kept the
cards apart (``GOLDEN``, taken with that reader on the trace below)."""
import json

import numpy as np
import pytest
import torch

from portbench import cells, harness, peaks, tracing
from portbench.campaign import Campaigns

SWEEP = "void cgra_sweep_kernel<4, 4>(Params)"


class FakeProf:
    """Stands in for ``torch.profiler.profile``: exports ``events``."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(name, ts, dur, cat, pid=0, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": pid, "tid": 7, "args": args}


def _span(name, ts, dur):
    return _x("portbench." + name, ts, dur, "user_annotation", pid=4242)


def one_card_events() -> list:
    """A traced window of two campaigns on card 0: overlapping kernels, a
    kernel running past the window, one before it, copies and a set,
    host operations and a span of the program (neither read)."""
    dev = lambda name, ts, dur, cat="kernel": _x(name, ts, dur, cat,
                                                  device=0)
    return [
        _span("window", 1000.0, 1000.0),
        _span("campaign", 1010.0, 480.0),
        _span("plan", 1010.0, 90.0),
        _span("sweep", 1100.0, 350.0),
        _span("chunk_loop", 1120.0, 320.0),
        _span("to_host", 1450.0, 40.0),
        _span("campaign", 1500.0, 490.0),
        _span("plan", 1500.0, 60.0),
        _span("sweep", 1560.0, 400.0),
        _span("chunk_loop", 1570.0, 380.0),
        _x("dse.plan", 1010.0, 90.0, "user_annotation", pid=4242),
        _x("aten::add_", 1130.0, 5.0, "cpu_op", pid=4242),
        dev(SWEEP, 900.0, 50.0),
        dev("Memcpy HtoD (Pageable -> Device)", 1050.0, 12.5, "gpu_memcpy"),
        dev(SWEEP, 1125.0, 150.25),
        dev(SWEEP, 1260.0, 120.0),
        dev("Memset (Device)", 1385.0, 3.0, "gpu_memset"),
        dev("void at::native::reduce_kernel<512, 1>(...)", 1400.0, 30.5),
        dev("Memcpy DtoH (Device -> Pageable)", 1455.0, 20.0,
            "gpu_memcpy"),
        dev(SWEEP, 1580.0, 170.0),
        dev(SWEEP, 1740.0, 200.0),
        dev("void at::native::reduce_kernel<512, 1>(...)", 1960.0, 80.0),
    ]


# the reader before cards were kept apart, on ``one_card_events``
GOLDEN = {
    "busy_s": 0.000721,
    "idle_gaps": [["plan", 0.00021749999999999997],
                  ["chunk_loop", 3.7e-05],
                  ["sweep", 2.45e-05]],
    "top_ops": [[SWEEP, 0.00064025],
                ["void at::native::reduce_kernel<512, 1>(...)",
                 0.00011049999999999999],
                ["Memcpy DtoH (Device -> Pageable)", 1.9999999999999998e-05],
                ["Memcpy HtoD (Pageable -> Device)", 1.2499999999999999e-05],
                ["Memset (Device)", 3e-06]],
    "sweep_kernel_ms": 0.320125,
    "other_device_ms": 0.073,
    "idle_share": 27.900000000000002,
    "sweep_roofline": 7.804763764154627,
    "campaign_peak_share": 5.151546391752578,
}
METRICS = ("sweep_kernel_ms", "other_device_ms", "idle_share",
           "sweep_roofline", "campaign_peak_share")


def _readings(trace) -> harness.Readings:
    return harness.Readings(wall_s=[0.00048, 0.00049], plan_s=[0.0, 0.0],
                            launches=[2, 2], answer_bytes=[0, 0],
                            least_s=[0.000025, 0.00002497], trace=trace,
                            peak_bytes=1)


def test_one_card_trace_reads_as_before(tmp_path):
    t = tracing.Trace(FakeProf(one_card_events()), tmp_path)
    assert t.busy_s == GOLDEN["busy_s"]
    assert t.idle_gaps() == GOLDEN["idle_gaps"]
    assert t.top_ops() == GOLDEN["top_ops"]
    r = _readings(t)
    for name in METRICS:
        assert cells.metric_reader(name)(r) == GOLDEN[name], name
    assert t.card_busy_s == [t.busy_s]
    # with one card every card is busy whenever the card is
    assert 100.0 * t.all_busy_s / t.window_s == pytest.approx(
        100.0 - GOLDEN["idle_share"], rel=1e-12)


def cards_events(n: int) -> list:
    """Card ``c`` of ``n``: the sweep kernel over [1100 + 100c, 1500 +
    100c] and a copy over [1800, 1850], in a window of [1000, 2000]; the
    host in ``plan`` over [1000, 1300], ``chunk_loop`` over [1300, 1800]
    and ``campaign`` over [1000, 1990]."""
    ev = [_span("window", 1000.0, 1000.0), _span("campaign", 1000.0, 990.0),
          _span("plan", 1000.0, 300.0), _span("chunk_loop", 1300.0, 500.0)]
    for c in range(n):
        ev += [_x(SWEEP, 1100.0 + 100 * c, 400.0, "kernel", pid=c, device=c),
               _x("Memcpy DtoH (Device -> Pageable)", 1800.0, 50.0,
                  "gpu_memcpy", pid=c, device=c)]
    return ev


# by hand: every card is busy 450 us; the kernels overlap on all cards
# for 1500 - (1100 + 100 (n-1)) us, the copies for 50; card c idles 100 +
# 100c us in the plan, 300 - 100c in the chunk loop, 150 in the campaign
BY_HAND = {2: {"all_busy_us": 350.0, "gaps_us": {"plan": 300.0,
                                                 "chunk_loop": 500.0,
                                                 "campaign": 300.0}},
           4: {"all_busy_us": 150.0, "gaps_us": {"plan": 1000.0,
                                                 "chunk_loop": 600.0,
                                                 "campaign": 600.0}}}


@pytest.mark.parametrize("n", [2, 4])
def test_cards_are_read_apart(tmp_path, n):
    t = tracing.Trace(FakeProf(cards_events(n)), tmp_path, n)
    assert t.card_busy_s == pytest.approx([450e-6] * n, rel=1e-12)
    assert t.busy_s == pytest.approx(450e-6, rel=1e-12)
    assert t.all_busy_s == pytest.approx(BY_HAND[n]["all_busy_us"] * 1e-6,
                                         rel=1e-12)
    assert dict(t.idle_gaps()) == pytest.approx(
        {k: v * 1e-6 for k, v in BY_HAND[n]["gaps_us"].items()}, rel=1e-12)
    assert dict(t.top_ops()) == pytest.approx(
        {SWEEP: n * 400e-6, "Memcpy DtoH (Device -> Pageable)": n * 50e-6},
        rel=1e-12)
    r = harness.Readings(wall_s=[0.00099], plan_s=[0.0], launches=[n],
                         answer_bytes=[0], least_s=[0.00002], trace=t,
                         peak_bytes=1, chips=n)
    read = lambda name: cells.metric_reader(name)(r)
    assert read("all_cards_busy_share") == pytest.approx(
        BY_HAND[n]["all_busy_us"] / 10.0, rel=1e-12)
    assert read("idle_share") == pytest.approx(55.0, rel=1e-12)
    assert read("sweep_kernel_ms") == pytest.approx(n * 0.4, rel=1e-12)
    assert read("other_device_ms") == pytest.approx(n * 0.05, rel=1e-12)
    # one card's least time (20 us on each of n cards) over the kernel's
    # seconds on all of them; the cards' least time over the wall
    assert read("sweep_roofline") == pytest.approx(
        100.0 * 20e-6 * n / (n * 400e-6), rel=1e-12)
    assert read("campaign_peak_share") == pytest.approx(
        100.0 * 20e-6 / 990e-6, rel=1e-12)


def test_a_card_that_ran_nothing_is_idle(tmp_path):
    """Four cards, operations on two: the mean halves, no instant has
    every card busy, and the idle cards' whole window counts as gaps."""
    t = tracing.Trace(FakeProf(cards_events(2)), tmp_path, 4)
    assert t.card_busy_s == pytest.approx([450e-6, 450e-6, 0.0, 0.0])
    assert t.busy_s == pytest.approx(225e-6, rel=1e-12)
    assert t.all_busy_s == 0.0
    assert sum(v for _, v in t.idle_gaps()) == pytest.approx(
        4 * 1000e-6 - 2 * 450e-6, rel=1e-12)


@pytest.mark.parametrize("steps,lanes,words", [(10**9, 40960, 4096),
                                               (10**5, 40960, 4096),
                                               (123456789, 1000, 64)])
def test_least_seconds_splits_over_cards(steps, lanes, words):
    one = peaks.least_seconds(steps, lanes, words)
    pe = float(steps) * 16
    assert one == max(pe * 31 / (67e12 / 4), pe * 14 / 67e12,
                      2.0 * lanes * words * 4 / 3.35e12)
    assert peaks.least_seconds(steps, lanes, words, chips=1) == one
    assert peaks.least_seconds(steps, lanes, words, chips=4) == one / 4


@pytest.fixture(scope="module")
def cpu_profile():
    from repro_torch.core.characterization import characterize
    return characterize(device="cpu")


def _campaigns(tree, mix, profile, chips):
    cell = cells.load_cell(f"tiny.{mix}", root=tree)
    return Campaigns(cell.config, cell.mix, profile, "cpu", chips=chips)


def _same(a, b) -> None:
    for pa, pb in zip(a, b, strict=True):
        fields = (pa.items() if isinstance(pa, dict)
                  else pa._asdict().items())
        other = pb if isinstance(pb, dict) else pb._asdict()
        for k, v in fields:
            x, y = np.asarray(v), np.asarray(other[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), k


@pytest.mark.parametrize("mix", ["full", "front", "topk"])
def test_four_host_shards_answer_as_one(tiny_tree, mix, cpu_profile):
    """A campaign over a mesh of 4 host shards answers bit for bit as on
    one, through ``run`` and through ``run_split``."""
    one = _campaigns(tiny_tree, mix, cpu_profile, 1)
    four = _campaigns(tiny_tree, mix, cpu_profile, 4)
    assert one.mesh is None and four.mesh.devices.size == 4
    imgs = one.images(2**31 + 3, 1, 0)
    base = one.run(imgs)
    _same(base, four.run(imgs))
    _same(base, four.run_split(imgs))


@pytest.mark.parametrize("chips", [1, 4])
def test_mesh_is_passed_only_over_cards(tiny_tree, cpu_profile, chips,
                                        monkeypatch):
    """A one-chip campaign makes today's calls, with no ``mesh``
    argument; a four-chip one passes its mesh to every call, through
    ``dse.sweep`` and through ``make_bucketed_sweep_fn``."""
    from repro_torch.core import dse
    seen = {"sweep": [], "make_bucketed_sweep_fn": []}
    for name, calls in seen.items():
        def wrapped(*args, fn=getattr(dse, name), calls=calls, **kw):
            calls.append(kw)
            return fn(*args, **kw)
        monkeypatch.setattr(dse, name, wrapped)
    camp = _campaigns(tiny_tree, "full", cpu_profile, chips)
    imgs = camp.images(5, 1, 0)
    camp.run(imgs)
    n = len(seen["make_bucketed_sweep_fn"])
    camp.run_split(imgs)
    # run's sweep() makes its plan through the module's own name as well
    assert len(seen["sweep"]) == len(camp.calls)
    kws = seen["sweep"] + seen["make_bucketed_sweep_fn"][n:]
    assert len(kws) == 2 * len(camp.calls)
    for kw in kws:
        if chips == 1:
            assert "mesh" not in kw
        else:
            assert kw["mesh"] is camp.mesh
            assert kw["mesh"].flat() == [torch.device("cpu")] * 4
