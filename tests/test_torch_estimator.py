"""The port's estimator, cases (i)-(vi), against the reference.

``repro_torch.core.estimator`` is the reference's numpy estimator with a
host copy of the trace (run_program's tensors lie on any device) and
``.item()`` reads of the tensor ``HwConfig``.  On the 5 MiBench kernels
on all 5 topologies, a trace from the port's simulator and one from the
reference's must give: ``latency_cc``, ``lat_step`` and ``e_step_pe``
equal, energy and power within rtol=1e-5.  The contention model equals
the reference's and its own loop oracle; cases (iii)-(vi) reproduce the
detailed model's latency; case (vi) equals the sweep's fused estimate
of the same design point (latency exactly, energy within 1e-4, the bound
the reference sets between the two paths).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.apps import mibench as ref_mibench  # noqa: E402
from repro.core import estimator as ref_est, hwconfig as ref_hw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import mibench  # noqa: E402
from repro_torch.core import detailed, dse, estimator, hwconfig  # noqa: E402

TOPOS = sorted(ref_hw.TOPOLOGIES)


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """AUTO knobs resolve from an empty cache of this module's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "cache.json"))
        yield


@pytest.fixture(scope="module")
def port_profile(profile):
    return convert.profile_from_numpy(dataclasses.asdict(profile))


def _assert_estimates_equal(got, want, msg):
    assert set(got) == set(want) == set(estimator.CASES), msg
    for c in estimator.CASES:
        g, w = got[c], want[c]
        assert g.case == w.case == c
        assert g.latency_cc == w.latency_cc, f"{msg} case {c}"
        np.testing.assert_allclose(g.energy_pj, w.energy_pj, rtol=1e-5,
                                   err_msg=f"{msg} case {c}")
        np.testing.assert_allclose(g.power_mw, w.power_mw, rtol=1e-5,
                                   err_msg=f"{msg} case {c}")
        for f in ("e_step_pe", "lat_step"):
            gv, wv = getattr(g, f), getattr(w, f)
            assert (gv is None) == (wv is None), f"{msg} case {c} {f}"
            if gv is not None:
                np.testing.assert_array_equal(gv, wv,
                                              err_msg=f"{msg} case {c} {f}")


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("idx", range(5))
def test_estimate_all_cases_matches_reference(idx, topo, profile,
                                              port_profile):
    rk, pk = ref_mibench.all_kernels()[idx], mibench.all_kernels()[idx]
    rhw, phw = ref_hw.TOPOLOGIES[topo](), hwconfig.TOPOLOGIES[topo]()
    _, rtrace = rk.run(rhw)
    _, ptrace = pk.run(phw, device="cpu")
    want = ref_est.estimate_all_cases(rk.program, rtrace, profile, rhw)
    got = estimator.estimate_all_cases(pk.program, ptrace, port_profile,
                                       phw)
    _assert_estimates_equal(got, want, f"{pk.name}/{topo}")
    # a trace already on the host gives the same estimates
    host = type(ptrace)(*(t.numpy() for t in ptrace))
    _assert_estimates_equal(estimator.estimate_all_cases(
        pk.program, host, port_profile, phw), want, f"{pk.name}/{topo} host")


@pytest.mark.parametrize("topo", TOPOS)
def test_contention_model_matches_reference(topo):
    rng = np.random.default_rng(0)
    S, P = 40, 16
    is_mem = rng.random((S, P)) < 0.4
    addr = rng.integers(0, 4096, (S, P))
    rhw, phw = ref_hw.TOPOLOGIES[topo](), hwconfig.TOPOLOGIES[topo]()
    want = ref_est.mem_completion_np(is_mem, addr, rhw, 4096, 4)
    got = estimator.mem_completion_np(is_mem, addr, phw, 4096, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        estimator.mem_completion_np_loop(is_mem, addr, phw, 4096, 4), want)


def test_fig2_ladder_and_errors_match_reference(mibench_runs, profile,
                                                port_profile):
    """Cases (iii)-(vi) reproduce the detailed model's latency, and the
    Fig. 2 errors equal the reference's."""
    from repro.core import detailed as ref_detailed
    for (rk, _, rtrace), pk in zip(mibench_runs, mibench.all_kernels()):
        _, ptrace = pk.run(device="cpu")
        host = type(ptrace)(*(t.numpy() for t in ptrace))
        rep = detailed.report(pk.program, host, hwconfig.baseline())
        rrep = ref_detailed.report(rk.program, rtrace, ref_hw.baseline())
        got = estimator.estimate_all_cases(pk.program, ptrace, port_profile,
                                           hwconfig.baseline())
        want = ref_est.estimate_all_cases(rk.program, rtrace, profile,
                                          ref_hw.baseline())
        for c in estimator.CASES:
            if c in ("iii", "iv", "v", "vi"):
                assert got[c].latency_cc == rep.latency_cc, (pk.name, c)
            g = estimator.errors_vs_detailed(got[c], rep)
            w = ref_est.errors_vs_detailed(want[c], rrep)
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           atol=1e-12, err_msg=(pk.name, c))


def test_case_vi_equals_the_sweep_lane(port_profile):
    """The estimator and the sweep's fused case-(vi) estimate are two
    code paths over one design point."""
    ks = mibench.all_kernels()
    hw = hwconfig.baseline()
    images = np.stack([k.mem_init for k in ks])
    res = dse.sweep(programs=[k.program for k in ks], profile=port_profile,
                    hw_configs=[hw], mem_images=images, max_steps=2048,
                    device="cpu")
    D = len(ks)
    for g, k in enumerate(ks):
        _, trace = k.run(hw, device="cpu")
        est = estimator.estimate(k.program, trace, port_profile, hw, "vi")
        lane = g * D + g
        assert int(res.latency_cc[lane]) == est.latency_cc, k.name
        np.testing.assert_allclose(float(res.energy_pj[lane]),
                                   est.energy_pj, rtol=1e-4, err_msg=k.name)
