"""``correct`` comes out false for the control and for every fault a cell
can have, planted under a run that skips the look for a chip; a sound
run comes out true.  A cell over four cards runs here on four host
shards."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from portbench import cells, check, control, harness
from portbench.conftest import make_tree, tiny_config

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


def _run(tree, mix, profile, device="cpu", cell=None):
    cell = cell or cells.load_cell(f"tiny.{mix}", root=tree)
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


@pytest.fixture
def mesh_cell(tmp_path):
    """The tiny cell on 32 images (64 lanes, 16 a shard) over four
    chips.  A campaign checks 32 lanes, each image under a config drawn
    from the seed, so a shard goes unchecked with odds of 2**-8 at
    most."""
    cfg = tiny_config()
    cfg["calls"][0]["images"] = 32
    tree = make_tree(tmp_path, {"tiny32": cfg})
    return dataclasses.replace(cells.load_cell("tiny32.full", root=tree),
                               chips=4)


def _shards_fault(kind):
    """The mesh path's engine (``dse.sweep_shards``) with a fault."""
    from repro_torch.kernels.cgra_sweep.ops import sweep_shards

    def engine(shards, **kw):
        if kind == "state_unchanged":
            return [0] * len(shards)
        before = [[t.clone() for t in sh[3]] for sh in shards]
        counts = sweep_shards(shards, **kw)
        if kind == "half_left_out":              # the later shards' lanes
            half = len(shards) // 2
            for sh, b in zip(shards[half:], before[half:]):
                for t, t0 in zip(sh[3], b):
                    t.copy_(t0)
        elif kind == "answer_altered":
            for sh in shards:
                sh[3].t_cc.add_(1)
        else:                                    # "last_shard_altered"
            shards[-1][3].t_cc.add_(1)
        return counts
    return engine


def _exchange_left_out(run):
    """The gather on the first card without the other cards' fields: the
    first shard's lanes, zeros for the rest."""
    def gathered(self, placed):
        res = run(self, placed)
        per = len(placed[1][0][1])
        return type(res)(*(torch.cat([f[:per], torch.zeros_like(f[per:])])
                           for f in res))
    return gathered


def test_sound_mesh_run_is_correct(mesh_cell, profile):
    out = _run(None, "full", profile, cell=mesh_cell)
    assert out["correct"], out["numbers"]
    assert out["campaigns"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered", "last_shard_altered"])
def test_mesh_engine_fault_is_not_correct(mesh_cell, fault, profile,
                                          monkeypatch):
    """Faults of the shards' engine; a fault in the last of four shards
    alone shows that the seed-drawn checked lanes reach every card."""
    from repro_torch.core import dse
    monkeypatch.setattr(dse, "sweep_shards", _shards_fault(fault))
    out = _run(None, "full", profile, cell=mesh_cell)
    assert not out["correct"]
    assert out["numbers"]["int_mismatch"] > 0


def test_mesh_exchange_left_out_is_not_correct(mesh_cell, profile,
                                               monkeypatch):
    from repro_torch.core import dse
    monkeypatch.setattr(dse.MeshGrid, "run",
                        _exchange_left_out(dse.MeshGrid.run))
    out = _run(None, "full", profile, cell=mesh_cell)
    assert not out["correct"]
    assert out["numbers"]["int_mismatch"] > 0


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
