"""A configuration names its array: the shape reaches the campaign's calls,
the check and the work count, and every 4x4 cell makes the calls and
reads the numbers it did before configurations named their array."""
import json

import pytest
import torch

from portbench import cells, peaks
from portbench.campaign import ARRAY, Campaigns, array_shape
from portbench.conftest import ROOT, probe_config, tiny_config

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# the keywords of every call before configurations named their array
SWEEP_KW = {"programs", "profile", "hw_configs", "mem_images", "max_steps",
            "mem_size", "reduce", "device"}
PLAN_KW = {"max_steps", "mem_size", "reduce", "device"}


def _recording(monkeypatch):
    """``dse.sweep`` and ``make_bucketed_sweep_fn`` replaced by stubs that
    record their keywords and answer zeros."""
    from repro_torch.core import dse
    seen = {"sweep": [], "make_bucketed_sweep_fn": []}

    def answer(kw):
        return (kw["reduce"] if kw["reduce"] is not None
                else tuple(torch.zeros(1) for _ in range(5)))

    def sweep(*args, **kw):
        seen["sweep"].append((args, kw))
        return answer(kw)

    def plan(*args, **kw):
        seen["make_bucketed_sweep_fn"].append((args, kw))
        return lambda: answer(kw)

    monkeypatch.setattr(dse, "sweep", sweep)
    monkeypatch.setattr(dse, "make_bucketed_sweep_fn", plan)
    return seen


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_makes_today_s_calls(workload, monkeypatch):
    """Each cell's campaign passes ``dse.sweep`` and
    ``make_bucketed_sweep_fn`` exactly the keywords it passed before (and
    ``mesh`` over several cards), and no array shape."""
    cell = cells.load_cell(workload)
    assert "rows" not in cell.config and "cols" not in cell.config
    seen = _recording(monkeypatch)
    camp = Campaigns(cell.config, cell.mix, "profile", "cpu",
                     chips=cell.chips)
    assert (camp.rows, camp.cols) == (4, 4)
    imgs = [f"images {i}" for i in range(len(camp.calls))]
    camp.run(imgs)
    camp.run_split(imgs)
    mesh = {"mesh"} if cell.chips > 1 else set()
    assert len(seen["sweep"]) == len(camp.calls)
    assert len(seen["make_bucketed_sweep_fn"]) == len(camp.calls)
    for i, ((args, kw), (pargs, pkw)) in enumerate(
            zip(seen["sweep"], seen["make_bucketed_sweep_fn"])):
        assert args == () and set(kw) == SWEEP_KW | mesh
        assert set(pkw) == PLAN_KW | mesh
        assert pargs == (camp.programs[i], "profile", camp.hw_configs,
                         imgs[i])
        for k in ("max_steps", "mem_size", "reduce", "device"):
            assert kw[k] == pkw[k]
        assert kw["max_steps"] == int(camp.calls[i]["max_steps"])
        assert kw["mem_size"] == 4096 and kw["device"] == torch.device("cpu")
        assert kw["programs"] is camp.programs[i]
        assert kw["mem_images"] == imgs[i]


@pytest.mark.parametrize("shape", [(2, 8), (8, 8)])
def test_another_array_is_passed_to_every_call(shape, monkeypatch):
    seen = _recording(monkeypatch)
    camp = Campaigns(probe_config(*shape), {"reduce": None}, "profile",
                     "cpu")
    camp.run([None])
    camp.run_split([None])
    for _, kw in seen["sweep"] + seen["make_bucketed_sweep_fn"]:
        assert (kw["rows"], kw["cols"]) == shape
        assert set(kw) - {"rows", "cols"} <= SWEEP_KW


def test_array_shape_of_a_configuration():
    assert array_shape(tiny_config()) == ARRAY == (4, 4)
    assert array_shape({"rows": 2, "cols": 8}) == (2, 8)
    assert array_shape({"rows": 4, "cols": 4}) == (4, 4)
    for bad in ({"rows": 8}, {"cols": 8}, {"rows": 0, "cols": 8},
                {"rows": 2.0, "cols": 8}, {"rows": True, "cols": 8},
                {"rows": "8", "cols": "8"}):
        with pytest.raises(ValueError, match="rows"):
            array_shape({"name": "bad", **bad})


@pytest.mark.parametrize("steps,lanes,words,chips",
                         [(10**9, 40960, 4096, 1), (10**5, 40960, 4096, 1),
                          (123456789, 1000, 64, 1), (5_450 * 40960, 40960,
                                                     4096, 4),
                          (3_617_400, 204_800, 4096, 1), (1, 1, 1, 4)])
def test_least_seconds_at_16_pes_is_the_frozen_formula(steps, lanes, words,
                                                       chips):
    """The least time at 16 PEs is, float for float, the count of the
    4x4 array before the count took the PE count."""
    pe = float(steps) * 16
    frozen = max(pe * 31 / (67e12 / 4), pe * 14 / 67e12,
                 2.0 * lanes * words * 4 / 3.35e12) / chips
    assert peaks.least_seconds(steps, lanes, words, chips=chips,
                               pes=16) == frozen
    assert peaks.least_seconds(steps, lanes, words, chips=chips) == frozen


def test_int32_count_grows_with_the_array():
    """31 at 16 PEs; store arbitration P // 2 and one relaxation a
    max-plus round, (P - 2).bit_length() rounds, carry the growth."""
    assert peaks.i32_ops_per_pe_step(16) == 31
    assert peaks.i32_ops_per_pe_step(32) == 31 + 8 + 1
    assert peaks.i32_ops_per_pe_step(64) == 31 + 24 + 2
    assert peaks.i32_ops_per_pe_step(8) == 31 - 4 - 1
    steps = 10**9
    assert peaks.least_seconds(steps, 1, 1, pes=64) == (
        float(steps) * 64 * 57 / (67e12 / 4))
