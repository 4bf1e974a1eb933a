"""The plain reference against the port's plain path on the CPU: the
profile, a tiny campaign of each configuration, seeded probes on arrays
of several shapes, and the reductions."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench import cells, check
from portbench.campaign import Campaigns
from portbench.reference import front as ref_front
from portbench.reference import hw as ref_hw
from portbench.reference import isa as ref_isa
from portbench.reference import probe as ref_probe
from portbench.reference import profile as ref_profile
from portbench.reference import sweep as ref_sweep


@pytest.fixture(scope="module")
def port_profile():
    from repro_torch.core.characterization import characterize
    return characterize(device="cpu")


def test_reference_profile_equals_the_port_s(port_profile):
    mine = ref_profile.characterize()
    for f in dataclasses.fields(port_profile):
        assert np.array_equal(np.asarray(mine[f.name]),
                              np.asarray(getattr(port_profile, f.name))), \
            f.name


def _tiny(name: str) -> dict:
    """The configuration on one image a call, two hardware configs and
    48 steps a lane: every program's first instructions."""
    cfg = cells.load_cell(f"{name}.full").config
    cfg["hardware"] = {"topologies": ["b_n_to_m", "d_dma_per_pe"],
                       "smul_lat": [1, 3], "n_banks": [2]}
    for call in cfg["calls"]:
        call["images"], call["max_steps"] = 1, 48
    return cfg


@pytest.mark.parametrize("name", ["conv-study", "mibench-fig2"])
def test_reference_equals_port_plain_path(name, port_profile):
    cfg = _tiny(name)
    camp = Campaigns(cfg, {"reduce": None}, port_profile, "cpu")
    inp = check.Inputs(camp.calls, camp.ref_programs, camp.hw,
                       camp.mem_size, None)
    answer = camp.run(camp.images(5, 1, 0))
    every = [np.arange(n) for n in camp.lanes]
    ref = check.reference_answers(inp, 5, {0: every}, "cpu")[0]
    for got, want in zip(answer, ref):
        for f in check.FIELDS:
            assert np.array_equal(got[f], want[f]), f
        assert (want["steps_executed"] > 0).all()


def _probes(rows: int, cols: int, seeds=(0, 1, 2)):
    """The probe kernels built by the reference's builder and by the
    port's, ``ProgramBuilder(n_pes=rows * cols)`` each: the same arrays."""
    from repro_torch.core import isa as port_isa
    from repro_torch.core.program import ProgramBuilder
    mine, port = [], []
    for s in seeds:
        mine.append(ref_probe.probe(rows, cols, s).program)
        pb = ProgramBuilder(n_pes=rows * cols, name=mine[-1].name)
        ref_probe.emit(pb, port_isa.asm, rows, cols, s)
        port.append(pb.build())
        for f in ref_isa.FIELDS:
            assert np.array_equal(getattr(port[-1], f),
                                  getattr(mine[-1], f)), f
    return mine, port


@pytest.mark.parametrize("rows,cols", [(4, 4), (2, 8), (8, 8)])
def test_reference_equals_port_plain_path_on_any_array(rows, cols,
                                                       port_profile):
    """``run_lanes(rows=, cols=)`` against the port's
    ``make_sweep_fn(rows=, cols=)`` on the CPU, bit for bit in every
    field: probes that read all four neighbours, meet on banks and DMA
    engines under ``b_n_to_m`` and ``d_dma_per_pe`` and branch."""
    from repro_torch.core import dse, hwconfig
    mine, port = _probes(rows, cols)
    hw = ref_hw.grid({"topologies": ["b_n_to_m", "baseline",
                                     "d_dma_per_pe"],
                      "smul_lat": [1, 3], "n_banks": [2, 4]})
    B = 24
    rng = np.random.default_rng([rows, cols])
    mem = torch.as_tensor(rng.integers(-999, 999, (B, 4096)),
                          dtype=torch.int32)
    prog = np.arange(B) % len(mine)
    lane_hw = [hw[k] for k in rng.integers(0, len(hw), B)]
    want = ref_sweep.run_lanes(mine, prog, lane_hw, mem.clone(), [64] * B,
                               ref_profile.characterize(), rows=rows,
                               cols=cols)
    fn = dse.make_sweep_fn(port, port_profile, rows=rows, cols=cols,
                           max_steps=64, device="cpu")
    got = fn(mem.clone(),
             hwconfig.stack_configs([hwconfig.HwConfig(**h)
                                     for h in lane_hw]),
             torch.as_tensor(prog, dtype=torch.int32))
    for f, g in zip(check.FIELDS, got):
        assert np.array_equal(g.numpy(), want[f].numpy()), f
    # every lane branched back and ran the loop to its end
    assert (want["steps_executed"] == 31).all()
    assert len(set(want["latency_cc"].tolist())) > 1


def _oracle(spec, fields, block):
    from repro_torch.analysis import pareto
    n = len(fields["latency_cc"])
    return pareto.reduce_oracle(
        spec, tuple(fields[f] for f in check.FIELDS),
        np.arange(n) // block, np.arange(n), n // block)


@pytest.mark.parametrize("seed", range(4))
def test_plain_reductions_equal_the_port_oracle(seed):
    from repro_torch.analysis import pareto
    rng = np.random.default_rng(seed)
    n, block = 600, 200
    fields = {"latency_cc": rng.integers(1, 9, n).astype(np.int32),
              "energy_pj": rng.integers(1, 9, n).astype(np.float32),
              "power_mw": rng.random(n).astype(np.float32),
              "checksum": rng.integers(0, 99, n).astype(np.int32),
              "steps_executed": rng.integers(1, 9, n).astype(np.int32)}
    for mine, spec in (
            (ref_front.pareto_fronts(fields, block,
                                     ("latency_cc", "energy_pj"), 16),
             pareto.ParetoFront(("latency_cc", "energy_pj"), 16)),
            (ref_front.top_k(fields, block, 8), pareto.TopK("edp", 8))):
        want = _oracle(spec, fields, block)
        for f in want._fields:
            assert np.array_equal(getattr(mine, f), getattr(want, f)), f
