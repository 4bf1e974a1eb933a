"""The plain reference against the port's plain path on the CPU: the
profile, a tiny campaign of each configuration, and the reductions."""
import dataclasses

import numpy as np
import pytest

from portbench import cells, check
from portbench.campaign import Campaigns
from portbench.reference import front as ref_front
from portbench.reference import profile as ref_profile


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
