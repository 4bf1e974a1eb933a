"""``correct`` comes out false for the control and for every fault a cell
can have, planted under a run that skips the look for a chip; a sound
run comes out true."""
import time

import numpy as np
import pytest
import torch

from portbench import cells, check, control, harness

MIXES = ("full", "front", "topk")


@pytest.fixture(scope="module")
def profile():
    from repro_torch.core.characterization import characterize
    prof = characterize(device="cpu")
    return lambda dev: prof


@pytest.fixture(autouse=True)
def no_warm_up(monkeypatch):
    """The tiny cell has nothing to warm up on the CPU."""
    monkeypatch.setattr(harness, "WARMUP_CAMPAIGNS", 0)


def _run(tree, mix, profile, device="cpu"):
    cell = cells.load_cell(f"tiny.{mix}", root=tree)
    return harness.run_cell(cell, seed=2**31 + 77, seconds=0.01,
                            trace=False, device=device,
                            t_start=time.perf_counter(), workdir=tree,
                            profile_fn=profile)


def _engine_fault(kind):
    from repro_torch.kernels.cgra_sweep.ops import sweep_engine

    def engine(tables, hw, gidx, st, **kw):
        if kind == "state_unchanged":
            return None
        before = [t.clone() for t in st]
        sweep_engine(tables, hw, gidx, st, **kw)
        if kind == "half_left_out":
            half = st.mem.shape[0] // 2
            for t, t0 in zip(st, before):
                t[half:] = t0[half:]
        else:                                   # "answer_altered"
            st.t_cc.add_(1)
    return engine


def _altered_best(merge):
    """The reducer's answer altered where it is produced: its best
    candidate claims a thousandth less energy than it has."""
    def merged(spec, parts):
        r = merge(spec, parts)
        energy = np.asarray(r.energy_pj).copy()
        energy[:, 0] *= np.float32(0.999)
        return r._replace(energy_pj=energy)
    return merged


@pytest.mark.parametrize("mix", MIXES)
def test_sound_run_is_correct(tiny_tree, mix, profile):
    out = _run(tiny_tree, mix, profile)
    assert out["correct"], out["numbers"]
    assert out["campaigns"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_engine_fault_is_not_correct(tiny_tree, mix, fault, profile,
                                     monkeypatch):
    from repro_torch.core import dse
    monkeypatch.setattr(dse, "sweep_engine", _engine_fault(fault))
    assert not _run(tiny_tree, mix, profile)["correct"]


@pytest.mark.parametrize("mix", ["front", "topk"])
def test_reducer_fault_is_not_correct(tiny_tree, mix, profile, monkeypatch):
    from repro_torch.analysis import pareto
    monkeypatch.setattr(pareto, "merge_reduced",
                        _altered_best(pareto.merge_reduced))
    assert not _run(tiny_tree, mix, profile)["correct"]


@pytest.mark.parametrize("mix", MIXES)
def test_control_is_not_correct(tiny_tree, mix, profile):
    """The reference in bfloat16 in the program's place fails the check;
    the program on the same seeds passes it."""
    cell = cells.load_cell(f"tiny.{mix}", root=tiny_tree)
    rows = control.readings(cell, [11], [11, 12, 13], "cpu",
                            profile_fn=profile, emit=lambda row: None)
    assert [r["correct"] for r in rows] == [True, False, False, False]
    assert all(r["numbers"]["energy_rel_err"]
               > check.LIMITS["energy_rel_err"] for r in rows[1:])


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tiny_tree):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.characterization import characterize
    out = _run(tiny_tree, "topk", lambda dev: characterize(device=dev),
               "cuda")
    assert out["correct"], out["numbers"]
