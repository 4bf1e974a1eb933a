"""``correct`` comes out false for the control and for every fault a cell
can have, planted under a run that skips the look for a chip; a sound
run comes out true.  A cell over four cards runs here on four host
shards; a cell of a 2x8 array runs on a stand-in for a program that
takes the array's shape."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from portbench import cells, check, control, harness
from portbench.campaign import Campaigns
from portbench.conftest import make_tree, probe_config, tiny_config
from portbench.reference import sweep as ref_sweep

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


def _shaped_sweep(torus=None):
    """``dse.sweep`` of an unreduced call on an array of any shape, made
    of the port's plain path (``make_sweep_fn(rows=, cols=)``), as a
    program that takes the shape would answer; ``torus`` runs it on
    another array's neighbours instead (a planted fault)."""
    from repro_torch.core import dse, hwconfig

    def sweep(*, programs, profile, hw_configs, mem_images, max_steps,
              mem_size, reduce, device, rows=4, cols=4):
        assert reduce is None
        rows, cols = torus or (rows, cols)
        H, D = len(hw_configs), mem_images.shape[0]
        lane = np.arange(len(programs) * H * D)
        fn = dse.make_sweep_fn(list(programs), profile, rows=rows,
                               cols=cols, mem_size=mem_size,
                               max_steps=max_steps, device=device)
        return fn(mem_images[torch.as_tensor(lane % D)],
                  hwconfig.stack_configs([hw_configs[h]
                                          for h in lane // D % H]),
                  torch.as_tensor(lane // (H * D), dtype=torch.int32))
    return sweep


@pytest.fixture
def probe_cell(tmp_path):
    """A 2x8 configuration of two seeded probe kernels, unreduced."""
    tree = make_tree(tmp_path, {"probe2x8": probe_config(2, 8)})
    return cells.load_cell("probe2x8.full", root=tree)


def test_sound_run_on_another_array_is_correct(probe_cell, profile,
                                               monkeypatch):
    from repro_torch.core import dse
    monkeypatch.setattr(dse, "sweep", _shaped_sweep())
    out = _run(None, "full", profile, cell=probe_cell)
    assert out["correct"], out["numbers"]


def test_answer_on_another_torus_is_not_correct(probe_cell, profile,
                                                monkeypatch):
    """The 2x8 cell answered on the 4x4 array's neighbours: the same 16
    PEs on the wrong torus."""
    from repro_torch.core import dse
    monkeypatch.setattr(dse, "sweep", _shaped_sweep(torus=(4, 4)))
    out = _run(None, "full", profile, cell=probe_cell)
    assert not out["correct"]
    assert out["numbers"]["int_mismatch"] > 0


def test_reference_with_the_4x4_dma_engines_is_not_correct(
        probe_cell, profile, monkeypatch):
    """A reference that keeps ``pe % 4`` for the DMA engine on the 2x8
    array disagrees with the sound answer."""
    from repro_torch.core import dse
    monkeypatch.setattr(dse, "sweep", _shaped_sweep())
    mem_done = ref_sweep._mem_done
    monkeypatch.setattr(ref_sweep, "_mem_done",
                        lambda is_mem, addr, hw, M, cols:
                        mem_done(is_mem, addr, hw, M, 4))
    out = _run(None, "full", profile, cell=probe_cell)
    assert not out["correct"]
    assert out["numbers"]["int_mismatch"] > 0


@pytest.mark.parametrize("drop", ["rows", "cols"])
def test_set_up_refuses_half_a_shape(drop, profile):
    cfg = probe_config(2, 8)
    del cfg[drop]
    with pytest.raises(ValueError, match="'rows' and 'cols'"):
        Campaigns(cfg, {"reduce": None}, profile("cpu"), "cpu")


@pytest.mark.parametrize("rows,cols", [(8, 8), (2, 4)])
def test_set_up_refuses_programs_of_another_array(rows, cols, profile):
    """The 16-PE probes in a configuration of another array."""
    cfg = probe_config(4, 4)
    cfg.update(rows=rows, cols=cols)
    with pytest.raises(ValueError,
                       match=rf"program 'probe-4x4-1'.*{rows}x{cols}"):
        Campaigns(cfg, {"reduce": None}, profile("cpu"), "cpu")


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


def test_control_on_another_array_is_not_correct(probe_cell, profile,
                                                 monkeypatch):
    """The control and the program side both run on the configuration's
    2x8 array: the sound stand-in passes, the bfloat16 reference fails."""
    from repro_torch.core import dse
    monkeypatch.setattr(dse, "sweep", _shaped_sweep())
    rows = control.readings(probe_cell, [11], [11, 12, 13], "cpu",
                            profile_fn=profile, emit=lambda row: None)
    assert [r["correct"] for r in rows] == [True, False, False, False]


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tiny_tree):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.characterization import characterize
    out = _run(tiny_tree, "topk", lambda dev: characterize(device=dev),
               "cuda")
    assert out["correct"], out["numbers"]
