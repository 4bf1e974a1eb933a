"""The port's reduced, bucketed and mapping sweeps against the reference.

``dse.sweep(reduce=...)`` on the CPU must return the reference's
``dse.sweep(reduce=..., backend="xla")`` answer bit for bit -- candidate
indices, every field, ``count`` and ``clipped`` -- with one or four
length buckets, with and without ``observed_steps``; it must equal the
port's own ``reduce_oracle`` over its unreduced sweep; a held
``make_bucketed_sweep_fn`` plan of several buckets must equal the
unbucketed ``sweep``; and
``sweep(mappings=...)`` must fold (or not) like the reference.  The
reference's knobs are pinned (``chunk_steps``, ``blk_b``,
``max_buckets``), so no autotune cache is read.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.analysis import pareto as ref_pareto  # noqa: E402
from repro.apps import mibench as ref_mibench  # noqa: E402
from repro.core import dse as ref_dse, hwconfig as ref_hw  # noqa: E402
from repro.core.mapper import DAG as RefDAG  # noqa: E402
from repro.core.mapper import generate_candidates as ref_candidates  # noqa: E402,E501
from repro.core.program import MappingSet as RefMappingSet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis import pareto  # noqa: E402
from repro_torch.apps import mibench  # noqa: E402
from repro_torch.core import dse, hwconfig  # noqa: E402
from repro_torch.core.mapper import DAG, generate_candidates  # noqa: E402
from repro_torch.core.program import MappingSet  # noqa: E402

MAX_STEPS = 128
MEM = 128
KNOBS = dict(chunk_steps=64, blk_b=32)
SPECS = [pareto.TopK("edp", k=3),
         pareto.ParetoFront(axes=("latency_cc", "energy_pj"), max_points=4)]
IDS = [pareto.spec_to_str(s) for s in SPECS]
TOPOS = ("baseline", "c_interleaved")
# each kernel's largest steps_executed on this grid: crc32 runs into
# MAX_STEPS, so trip counts bucket the kernels unlike their lengths
OBSERVED = [79, 128, 14, 36]


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """AUTO knobs resolve from an empty cache of this module's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "cache.json"))
        yield


def _kernels(mod):
    return [mod.bitcnt(n_words=16), mod.crc32(n_words=3),
            mod.susan_thresh(n_pixels=16), mod.sha_mix(rounds=4)]


@pytest.fixture(scope="module")
def grid(profile):
    rk, pk = _kernels(ref_mibench), _kernels(mibench)
    mems = np.stack([rk[0].mem_init, rk[2].mem_init])
    return dict(
        ref=dict(programs=[k.program for k in rk], profile=profile,
                 hw_configs=[ref_hw.TOPOLOGIES[t]() for t in TOPOS],
                 mem_images=mems, max_steps=MAX_STEPS),
        port=dict(programs=[k.program for k in pk],
                  profile=convert.profile_from_numpy(
                      dataclasses.asdict(profile)),
                  hw_configs=[hwconfig.TOPOLOGIES[t]() for t in TOPOS],
                  mem_images=mems, max_steps=MAX_STEPS))


def _assert_reduced_equal(got, want, msg="", float_rtol=None):
    """Bit for bit; with ``float_rtol``, energy and power within it."""
    assert isinstance(got, pareto.ReducedResult)
    for f in pareto.REDUCED_FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert isinstance(g, np.ndarray), f"{msg}{f} is not on the host"
        assert g.dtype == w.dtype, f"{msg}{f}"
        if float_rtol and f in ("energy_pj", "power_mw"):
            np.testing.assert_allclose(g, w, rtol=float_rtol,
                                       err_msg=f"{msg}{f}")
        else:
            assert g.tobytes() == w.tobytes(), f"{msg}{f}: {g} != {w}"


# observed_steps changes only how kernels are bucketed: one bucket needs
# no case of its own
@pytest.mark.parametrize("max_buckets,observed",
                         [(1, None), (4, None), (4, OBSERVED)],
                         ids=["1-static", "4-static", "4-observed"])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_reduced_sweep_matches_reference(grid, spec, max_buckets, observed):
    """Candidates and integers bit for bit; energy and power at rtol=1e-5.
    The reference's own XLA sweep moves energy by an ULP between batch
    shapes (some lanes of this grid differ between its max_buckets=1 and
    4), where the port's buckets equal its unbucketed sweep bit for bit
    (next test)."""
    want = ref_dse.sweep(**grid["ref"], backend="xla",
                         max_buckets=max_buckets, observed_steps=observed,
                         reduce=ref_pareto.spec_from_str(
                             pareto.spec_to_str(spec)), **KNOBS)
    got = dse.sweep(**grid["port"], max_buckets=max_buckets,
                    observed_steps=observed, reduce=spec, device="cpu",
                    **KNOBS)
    _assert_reduced_equal(got, want, float_rtol=1e-5)
    assert int(got.count.sum()) > 0


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_reduced_sweep_equals_oracle_of_unreduced(grid, spec):
    res = dse.sweep(**grid["port"], max_buckets=4, device="cpu", **KNOBS)
    G, B = 4, res.latency_cc.shape[0]
    want = pareto.reduce_oracle(spec, [t.numpy() for t in res],
                                np.repeat(np.arange(G), B // G),
                                np.arange(B), G)
    for max_buckets in (1, 4):
        _assert_reduced_equal(dse.sweep(**grid["port"], reduce=spec,
                                        max_buckets=max_buckets,
                                        device="cpu", **KNOBS), want,
                              f"max_buckets={max_buckets}: ")


@pytest.mark.parametrize("reduce", [None, SPECS[0]], ids=["full", IDS[0]])
def test_bucketed_sweep_fn_equals_sweep(grid, reduce):
    kw = dict(grid["port"])
    programs = kw.pop("programs")
    fn = dse.make_bucketed_sweep_fn(programs, **kw, max_buckets=4,
                                    observed_steps=OBSERVED, reduce=reduce,
                                    device="cpu", **KNOBS)
    assert fn.buckets.n_buckets > 1
    # sweep() is one call of such a plan: hold the buckets to the
    # unbucketed sweep, a plan of one bucket
    want = dse.sweep(programs=programs, **kw, max_buckets=1,
                     reduce=reduce, device="cpu", **KNOBS)
    got = fn()
    if reduce is not None:
        _assert_reduced_equal(got, want)
        _assert_reduced_equal(fn(), want, "second call: ")
        return
    for f, g, w in zip(dse.SweepResult._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f)


def test_sweep_and_grid_fn_reduce_entry_points(grid):
    prof = grid["port"]["profile"]
    pk = _kernels(mibench)
    with pytest.raises(ValueError, match="batch API"):
        dse.make_sweep_fn(pk[0].program, prof, reduce=SPECS[0],
                          device="cpu")
    # a padded slice of the grid: lane_idx = -1 lanes never become
    # candidates, and the rest equal the oracle over the same lanes
    plan = dse.plan_grid(programs=[k.program for k in pk],
                         hw_configs=grid["port"]["hw_configs"],
                         mem_images=grid["port"]["mem_images"],
                         device="cpu")
    full = dse.make_grid_fn(plan, prof, max_steps=MAX_STEPS)(
        plan.img_idx, plan.hw_grid, plan.prog_idx)
    fn = dse.make_grid_fn(plan, prof, max_steps=MAX_STEPS, reduce=SPECS[1])
    sl = slice(3, 14)
    lane = np.arange(16, dtype=np.int32)[sl].copy()
    lane[::3] = -1
    got = fn(plan.img_idx[sl], plan.hw_grid.map(lambda x: x[sl]),
             plan.prog_idx[sl], lane)
    want = pareto.reduce_oracle(SPECS[1], [t.numpy()[sl] for t in full],
                                plan.prog_idx[sl], lane, 4)
    _assert_reduced_equal(pareto._as_numpy(got), want)
    assert not set(want.indices[want.indices >= 0].tolist()) & set(
        range(3, 14, 3))


def _dag(mod, n):
    d = mod()
    w = d.const(3 + n)
    for j in range(4 + n):
        t = d.alu("SMUL", d.load(j), w)
        t = d.alu("SADD", t, d.load(16 + j))
        d.store(32 + j, d.alu("SRA", t, d.const(2)))
    return d


@pytest.fixture(scope="module")
def msets():
    ref = [ref_candidates(_dag(RefDAG, g), 3, seed=g, name=f"k{g}")
           for g in range(2)]
    port = [generate_candidates(_dag(DAG, g), 3, seed=g, name=f"k{g}",
                                device="cpu") for g in range(2)]
    return (RefMappingSet.from_candidates(
        [[c.program for c in g] for g in ref], names=["k0", "k1"]),
        MappingSet.from_candidates(
        [[c.program for c in g] for g in port], names=["k0", "k1"]))


@pytest.fixture(scope="module")
def small_grid(profile):
    rng = np.random.default_rng(0)
    mems = rng.integers(-100, 100, (2, MEM)).astype(np.int32)
    kw = dict(mem_images=mems, max_steps=MAX_STEPS, mem_size=MEM, **KNOBS)
    return (dict(kw, profile=profile, hw_configs=[
        ref_hw.baseline(), ref_hw.baseline().replace(smul_lat=3)]),
        dict(kw, profile=convert.profile_from_numpy(
            dataclasses.asdict(profile)), hw_configs=[
            hwconfig.baseline(), hwconfig.baseline().replace(smul_lat=3)]))


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
def test_sweep_mappings_matches_reference(msets, small_grid, fold):
    rset, pset = msets
    rkw, pkw = small_grid
    spec = pareto.TopK("edp", 2)
    want = ref_dse.sweep(mappings=rset, backend="xla", max_buckets=4,
                         reduce=ref_pareto.TopK("edp", 2),
                         fold_mappings=fold, **rkw)
    got = dse.sweep(mappings=pset, max_buckets=4, reduce=spec,
                    fold_mappings=fold, device="cpu", **pkw)
    _assert_reduced_equal(got, want, float_rtol=1e-5)
    assert got.indices.shape == ((2, 2) if fold else (pset.n_total, 2))
    if not fold:
        _assert_reduced_equal(pareto.fold_segments(
            spec, got, pset.kernel_of, pset.n_kernels), dse.sweep(
            mappings=pset, max_buckets=4, reduce=spec, device="cpu", **pkw))


def test_sweep_mappings_unreduced_and_arg_validation(msets, small_grid):
    rset, pset = msets
    rkw, pkw = small_grid
    want = ref_dse.sweep(mappings=rset, backend="xla", max_buckets=4, **rkw)
    got = dse.sweep(mappings=pset, max_buckets=4, device="cpu", **pkw)
    for f, g, w in zip(dse.SweepResult._fields, got, want):
        if f in ("energy_pj", "power_mw"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f)
    with pytest.raises(TypeError, match="not both"):
        dse.sweep(mappings=pset, programs=list(pset.programs), device="cpu",
                  **pkw)
