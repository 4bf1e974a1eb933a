"""The sweep end to end: the port's dse.sweep on the CPU against the
reference's dse.sweep(backend="xla") on the same programs, hardware
grid and memory images.  latency_cc, checksum and steps_executed must be
bit-identical; energy_pj and power_mw agree at rtol=1e-5 (the bound
tests/test_sweep_backends.py sets between the reference's own two
backends)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.apps import conv as ref_conv, mibench as ref_mibench  # noqa: E402
from repro.core import dse as ref_dse, hwconfig as ref_hw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import conv, mibench  # noqa: E402
from repro_torch.core import dse, hwconfig  # noqa: E402

TOPOS = sorted(ref_hw.TOPOLOGIES)
INT_FIELDS = ("latency_cc", "checksum", "steps_executed")
KNOBS = dict(chunk_steps=64, blk_b=32)


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """AUTO knobs resolve from an empty cache of this module's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "cache.json"))
        yield


def _ref_sweep(profile, **kw):
    res = ref_dse.sweep(profile=profile,
                        hw_configs=[ref_hw.TOPOLOGIES[t]() for t in TOPOS],
                        backend="xla", max_buckets=1, **KNOBS, **kw)
    return [np.asarray(x) for x in res]


def _port_sweep(profile, **kw):
    res = dse.sweep(profile=convert.profile_from_numpy(
                        dataclasses.asdict(profile)),
                    hw_configs=[hwconfig.TOPOLOGIES[t]() for t in TOPOS],
                    device="cpu", **KNOBS, **kw)
    assert all(t.device.type == "cpu" for t in res)
    return [t.numpy() for t in res]


def _assert_close(got, want):
    for f, g, w in zip(dse.SweepResult._fields, got, want):
        assert g.shape == w.shape, f
        if f in INT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f)


@pytest.fixture(scope="module")
def mibench_grid(profile):
    """5 MiBench kernels x 5 topologies x 2 images (B = 50)."""
    rk, pk = ref_mibench.all_kernels(), mibench.all_kernels()
    images = np.stack([rk[1].mem_init, rk[3].mem_init])
    want = _ref_sweep(profile, programs=[k.program for k in rk],
                      mem_images=images, max_steps=2048)
    return [k.program for k in pk], images, want


@pytest.mark.parametrize("max_buckets", [1, 4])
def test_sweep_matches_reference_mibench_grid(max_buckets, mibench_grid,
                                              profile):
    progs, images, want = mibench_grid
    got = _port_sweep(profile, programs=progs, mem_images=images,
                      max_steps=2048, max_buckets=max_buckets)
    _assert_close(got, want)
    assert (got[4] > 0).all()


def test_sweep_matches_reference_conv_grid(profile):
    """2 conv mappings x 5 topologies x 1 image, in two length buckets."""
    rk = [ref_conv.all_mappings()[i] for i in (2, 3)]
    pk = [conv.all_mappings()[i] for i in (2, 3)]
    images = rk[0].mem_init[None]
    want = _ref_sweep(profile, programs=[k.program for k in rk],
                      mem_images=images, max_steps=9000)
    got = _port_sweep(profile, programs=[k.program for k in pk],
                      mem_images=images, max_steps=9000)
    _assert_close(got, want)
    # every lane ran its layer to EXIT: the conv outputs are correct
    assert (got[4] < 9000).all()


def test_single_program_api(profile):
    rk, pk = ref_mibench.all_kernels()[4], mibench.all_kernels()[4]
    images = np.stack([rk.mem_init, ref_mibench.all_kernels()[0].mem_init])
    want = _ref_sweep(profile, program=rk.program, mem_images=images,
                      max_steps=512)
    got = _port_sweep(profile, program=pk.program, mem_images=images,
                      max_steps=512)
    _assert_close(got, want)
    fn = dse.make_sweep_fn(pk.program, convert.profile_from_numpy(
        dataclasses.asdict(profile)), max_steps=512, device="cpu")
    hw = hwconfig.stack_configs([hwconfig.TOPOLOGIES[t]() for t in TOPOS])
    mems = np.repeat(images[:1], len(TOPOS), axis=0)
    res = fn(mems, hw)
    np.testing.assert_array_equal(res.latency_cc.numpy(), want[0][0::2])
    np.testing.assert_array_equal(mems, np.repeat(images[:1], 5, axis=0))


def _hw_values(H):
    """H configs' field values: the Table 2 topologies x ``smul_lat``
    {1, 3} x ``n_banks`` {2, 4, 8, 16}, as the benchmark's grid, with
    ``smul_power_scale`` 3.0 and a clock of 12.5 ns on some."""
    out = []
    for i in range(H):
        topo = ref_hw.TOPOLOGIES[TOPOS[i % len(TOPOS)]]()
        vals = {f: np.asarray(getattr(topo, f)).item()
                for f in ref_hw.HwConfig.FIELDS}
        vals.update(smul_lat=(1, 3)[i // 5 % 2],
                    n_banks=(2, 4, 8, 16)[i // 10 % 4])
        if i % 3 == 0:
            vals.update(smul_power_scale=3.0, t_clk_ns=12.5)
        out.append(vals)
    return out


@pytest.mark.parametrize("G,H,D,source", [(3, 5, 2, "topologies")] + [
    (G, H, D, source) for G, H, D in [(1, 40, 1024), (3, 5, 2), (4, 1, 7)]
    for source in ("numbers", "tensors")])
def test_plan_grid_order_matches_reference(G, H, D, source):
    """Every row of the plan, built from one hardware table, is the
    reference's bit for bit: index rows, each field with its dtype, the
    scoreboard bound.  ``topologies``: the Table 2 configs over MiBench
    images; else seeded images and ``_hw_values`` configs built from
    Python numbers or from tensors."""
    rk, pk = ref_mibench.all_kernels()[:G], mibench.all_kernels()[:G]
    if source == "topologies":
        images = np.stack([k.mem_init for k in rk[:D]])
        vals = [{f: np.asarray(getattr(ref_hw.TOPOLOGIES[t](), f)).item()
                 for f in ref_hw.HwConfig.FIELDS} for t in TOPOS]
    else:
        images = np.random.default_rng(G * H * D).integers(
            -2**31, 2**31, (D, 16), dtype=np.int64).astype(np.int32)
        vals = _hw_values(H)
    if source == "topologies":
        hws = [hwconfig.TOPOLOGIES[t]() for t in TOPOS]
    elif source == "tensors":
        hws = [hwconfig.HwConfig(**{f: torch.tensor(v) for f, v in
                                    c.items()}) for c in vals]
    else:
        hws = [hwconfig.HwConfig(**c) for c in vals]
    want = ref_dse.plan_grid(programs=[k.program for k in rk],
                             hw_configs=[ref_hw.HwConfig(**c)
                                         for c in vals],
                             mem_images=images)
    got = dse.plan_grid(programs=[k.program for k in pk], hw_configs=hws,
                        mem_images=images, device="cpu")
    for f in ("img_idx", "prog_idx"):
        assert getattr(got, f).dtype == np.int32, f
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
    assert got.n_lanes == G * H * D
    assert got.max_banks == want.max_banks
    for f in ref_hw.HwConfig.FIELDS:
        g = getattr(got.hw_grid, f).numpy()
        w = np.asarray(getattr(want.hw_grid, f))
        assert g.shape == (G * H * D,) and g.dtype == w.dtype, f
        assert g.tobytes() == w.tobytes(), f
    np.testing.assert_array_equal(got.images.numpy(), images)


@pytest.mark.parametrize("reduce", [None, "topk"])
def test_bucketed_lane_rows_equal_the_numpy_rows(reduce, monkeypatch,
                                                 profile):
    """The rows each bucket's grid fn receives, built on the device from
    ``arange``, equal the plan's numpy rows; with a reducer, the
    canonical lane index of each lane of the bucket's programs."""
    from repro_torch.analysis import pareto
    progs = [m.program for m in conv.all_mappings()]
    hws = [hwconfig.TOPOLOGIES[t]() for t in TOPOS[:2]]
    images = np.random.default_rng(3).integers(
        0, 100, (3, conv.all_mappings()[0].mem_init.shape[0])
    ).astype(np.int32)
    seen, real = [], dse.make_grid_fn

    def recording(plan, prof, **kw):
        f = real(plan, prof, **kw)
        return lambda *args: seen.append((plan, args)) or f(*args)

    monkeypatch.setattr(dse, "make_grid_fn", recording)
    fn = dse.make_bucketed_sweep_fn(
        progs, convert.profile_from_numpy(dataclasses.asdict(profile)), hws,
        images, max_steps=8, chunk_steps=8, blk_b=32, max_buckets=4,
        reduce=None if reduce is None else pareto.TopK("edp", 2),
        device="cpu")
    fn()
    assert len(fn.buckets.groups) == len(seen) == 3
    block = len(hws) * images.shape[0]
    stacked = hwconfig.stack_configs(hws)
    for (plan, args), group in zip(seen, fn.buckets.groups):
        img_idx, hw, prog_idx, *lane = args
        assert img_idx.dtype == prog_idx.dtype == torch.int32
        np.testing.assert_array_equal(img_idx.numpy(), plan.img_idx)
        np.testing.assert_array_equal(prog_idx.numpy(), plan.prog_idx)
        assert hw is plan.hw_grid
        for f in hwconfig.HwConfig.FIELDS:
            want = getattr(stacked, f).repeat_interleave(
                images.shape[0]).repeat(len(group))
            assert torch.equal(getattr(hw, f), want), f
        if reduce is None:
            assert lane == []
            continue
        (lane,) = lane
        assert lane.dtype == torch.int32
        np.testing.assert_array_equal(lane.numpy(), np.concatenate(
            [np.arange(g * block, (g + 1) * block) for g in group]))


def test_grid_fn_slice_equals_full_sweep(mibench_grid, profile):
    progs, images, want = mibench_grid
    plan = dse.plan_grid(programs=progs,
                         hw_configs=[hwconfig.TOPOLOGIES[t]() for t in TOPOS],
                         mem_images=images, device="cpu")
    fn = dse.make_grid_fn(plan, convert.profile_from_numpy(
        dataclasses.asdict(profile)), max_steps=2048)
    sl = slice(17, 33)
    res = fn(plan.img_idx[sl], plan.hw_grid.map(lambda x: x[sl]),
             plan.prog_idx[sl])
    _assert_close([t.numpy() for t in res], [w[sl] for w in want])


def test_bank_bound_is_enforced(profile):
    pk = mibench.all_kernels()[4]
    prof = convert.profile_from_numpy(dataclasses.asdict(profile))
    fn = dse.make_sweep_fn(pk.program, prof, max_steps=64, max_banks=16,
                           device="cpu")
    hw = hwconfig.stack_configs([hwconfig.HwConfig(bus=1, interleaved=1,
                                                   n_banks=32)])
    with pytest.raises(AssertionError, match="max_banks=16"):
        fn(pk.mem_init[None], hw)
    with pytest.raises(AssertionError, match="HARD_MAX_BANKS"):
        dse.sweep(pk.program, prof, [hwconfig.HwConfig(n_banks=512)],
                  pk.mem_init[None], max_steps=64, device="cpu")


def test_sweep_32_bank_config_matches_reference(profile):
    """A config beyond the default 16-bank bound runs when sweep()
    derives the bound, and agrees with the reference."""
    rk, pk = ref_mibench.all_kernels()[3], mibench.all_kernels()[3]
    rcfg = [ref_hw.HwConfig(bus=1, interleaved=1, n_banks=32, dma_per_pe=1)]
    want = jax.tree.map(np.asarray, ref_dse.sweep(
        rk.program, profile, rcfg, rk.mem_init[None], max_steps=512,
        backend="xla", max_buckets=1, **KNOBS))
    got = dse.sweep(pk.program, convert.profile_from_numpy(
        dataclasses.asdict(profile)), [hwconfig.HwConfig(
            bus=1, interleaved=1, n_banks=32, dma_per_pe=1)],
        pk.mem_init[None], max_steps=512, device="cpu", **KNOBS)
    _assert_close([t.numpy() for t in got], want)


def test_sweep_without_device_raises_when_no_cuda(profile):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: sweep() would use it")
    pk = mibench.all_kernels()[4]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dse.sweep(pk.program, convert.profile_from_numpy(
            dataclasses.asdict(profile)), [hwconfig.baseline()],
            pk.mem_init[None], max_steps=64)
