"""The port's sweep split across devices against the unsharded sweeps.

``sweep(mesh=)``, ``make_grid_fn(mesh=)``, the runner's elastic re-plan
and ``checkpoint.restore_resharded`` run here on host shards: a mesh may
repeat a device, so ``make_debug_mesh(8, device="cpu")`` is eight shards
of the plain engine in one process.  The reference's own ``mesh=`` path
raises under the installed jax (``jnp.take`` with a sharded index), so
every sharded answer is held to the reference's *unsharded* sweep
(integers and candidate indices bit for bit, energy and power at rtol
1e-5) and to the port's unsharded sweep (bit for bit, energy included).
The cases follow the reference's mesh tests: one shard (test_dse), a
packed grid on 2x4 and 8 shards (test_program_batch), a single program
on 1 and 8 shards (test_sweep_backends), reduced sweeps padded from 12
to 16 lanes (test_pareto), the mapping axis (test_mapping_axis), a
(2, 4, 8) mesh of 64 shards (test_dse_multipod), a runner losing half
its shards (test_sweep_service) and an elastic restore
(test_fault_tolerance).  Engine knobs are pinned, so no autotune cache
is read.
"""
import collections
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
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    restore_resharded, save_tree)
from repro_torch.core import dse, hwconfig  # noqa: E402
from repro_torch.core.autotune import (ShapeClass, TunedConfig,  # noqa: E402
                                       default_cache, tune_sweep)
from repro_torch.core.mapper import DAG, generate_candidates  # noqa: E402
from repro_torch.core.program import MappingSet, as_program_batch  # noqa: E402,E501
from repro_torch.kernels.cgra_sweep import ops as sweep_ops  # noqa: E402
from repro_torch.kernels.cgra_sweep.ref import (_chunk,  # noqa: E402
                                                init_lanes, sweep_ref)
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_mesh  # noqa: E402
from repro_torch.parallel import (Mesh, flat_shards, pad_batch,  # noqa: E402
                                  padded_len)
from repro_torch.runtime.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.service import (FleetMonitor,  # noqa: E402
                                 ResumableSweepRunner)

KNOBS = dict(chunk_steps=64, blk_b=32)
DISCRETE = ("latency_cc", "checksum", "steps_executed")
FIELDS = dse.SweepResult._fields


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """AUTO knobs resolve from an empty cache of this module's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "cache.json"))
        yield


@pytest.fixture(scope="module")
def port_prof(profile):
    return convert.profile_from_numpy(dataclasses.asdict(profile))


def cpu_mesh(n):
    return make_debug_mesh(n, device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_sharded(got, port_want, ref_want):
    """``got`` equals the port's unsharded sweep bit for bit and the
    reference's under the contract."""
    for f in FIELDS:
        g, p = getattr(got, f), getattr(port_want, f)
        assert g.dtype == p.dtype and g.device == p.device, f
        assert torch.equal(g, p), f"{f} differs from the unsharded port"
        r = _np(getattr(ref_want, f))
        if f in DISCRETE:
            np.testing.assert_array_equal(_np(g), r, err_msg=f)
        else:
            np.testing.assert_allclose(_np(g), r, rtol=1e-5, err_msg=f)


def _assert_reduced(got, port_want, ref_want=None):
    for f in pareto.REDUCED_FIELDS:
        g, p = getattr(got, f), np.asarray(getattr(port_want, f))
        assert isinstance(g, np.ndarray) and g.dtype == p.dtype, f
        assert g.tobytes() == p.tobytes(), f"{f}: {g} != {p}"
        if ref_want is None:
            continue
        r = np.asarray(getattr(ref_want, f))
        if f in ("energy_pj", "power_mw"):
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


def _grid(port_prof, profile, kernels, topos, images, max_steps):
    """Matching keyword sets of one grid for the port and the reference."""
    pk = [getattr(mibench, n)(**kw) for n, kw in kernels]
    rk = [getattr(ref_mibench, n)(**kw) for n, kw in kernels]
    mems = np.stack([rk[i].mem_init for i in images])
    return (dict(programs=[k.program for k in pk], profile=port_prof,
                 hw_configs=[hwconfig.TOPOLOGIES[t]() for t in topos],
                 mem_images=mems, max_steps=max_steps, device="cpu",
                 **KNOBS),
            dict(programs=[k.program for k in rk], profile=profile,
                 hw_configs=[ref_hw.TOPOLOGIES[t]() for t in topos],
                 mem_images=mems, max_steps=max_steps, backend="xla",
                 max_buckets=1, **KNOBS))


ALL_TOPOS = tuple(sorted(hwconfig.TOPOLOGIES))
THREE = [("bitcnt", dict(n_words=16)), ("crc32", dict(n_words=3)),
         ("susan_thresh", dict(n_pixels=16))]


@pytest.fixture(scope="module")
def packed(port_prof, profile):
    """3 kernels x 5 topologies x 3 images = 45 lanes (pads to 48 on 8)."""
    port, ref = _grid(port_prof, profile, THREE, ALL_TOPOS, [0, 1, 2], 256)
    return port, dse.sweep(**port, max_buckets=1), ref_dse.sweep(**ref)


# ---------------------------------------------------------------------------
# Sweeps on a mesh against the unsharded sweeps
# ---------------------------------------------------------------------------

def test_sweep_on_mesh_single_shard(port_prof, profile):
    """test_dse.py's one-device mesh: the whole sha kernel, one lane."""
    k, rk = mibench.sha_mix(), ref_mibench.sha_mix()
    kw = dict(hw_configs=[hwconfig.baseline()], mem_images=k.mem_init[None],
              max_steps=k.max_steps, device="cpu", **KNOBS)
    got = dse.sweep(k.program, port_prof, mesh=cpu_mesh(1), **kw)
    want = dse.sweep(k.program, port_prof, **kw)
    ref = ref_dse.sweep(rk.program, profile, [ref_hw.baseline()],
                        rk.mem_init[None], max_steps=rk.max_steps,
                        backend="xla", **KNOBS)
    _assert_sharded(got, want, ref)
    assert int(got.latency_cc[0]) > 0


@pytest.mark.parametrize("max_buckets", [1, 4])
@pytest.mark.parametrize("shape", [(2, 4), (8,)], ids=["2x4", "8"])
def test_packed_grid_sharded(packed, shape, max_buckets):
    """test_program_batch.py's packed grid on a 2x4 and an 8-shard mesh,
    45 lanes padded to 48; with four buckets each bucket shards on its
    own."""
    port, want, ref = packed
    mesh = make_mesh(shape, ("pod", "data")[-len(shape):],
                     devices=["cpu"] * 8)
    got = dse.sweep(**port, max_buckets=max_buckets, mesh=mesh)
    _assert_sharded(got, want, ref)


@pytest.mark.parametrize("n", [1, 8])
def test_single_program_sharded(port_prof, profile, n):
    """test_sweep_backends.py: one program x 5 topologies x 3 images,
    15 lanes (padded to 16 on 8 shards)."""
    k, rk = mibench.bitcnt(n_words=16), ref_mibench.bitcnt(n_words=16)
    mems = np.stack([k.mem_init] * 3)
    kw = dict(hw_configs=[hwconfig.TOPOLOGIES[t]() for t in ALL_TOPOS],
              mem_images=mems, max_steps=256, device="cpu", **KNOBS)
    got = dse.sweep(k.program, port_prof, mesh=cpu_mesh(n), **kw)
    want = dse.sweep(k.program, port_prof, **kw)
    ref = ref_dse.sweep(rk.program, profile,
                        [ref_hw.TOPOLOGIES[t]() for t in ALL_TOPOS], mems,
                        max_steps=256, backend="xla", **KNOBS)
    _assert_sharded(got, want, ref)


SPECS = [pareto.TopK("edp", k=3),
         pareto.ParetoFront(axes=("latency_cc", "energy_pj"), max_points=8)]


@pytest.fixture(scope="module")
def twelve(port_prof, profile):
    """test_pareto.py's grid: 2 kernels x 3 topologies x 2 images = 12
    lanes, padded to 16 on 8 shards."""
    port, ref = _grid(port_prof, profile, THREE[:2],
                      ("baseline", "c_interleaved", "d_dma_per_pe"), [0, 1],
                      256)
    return port, ref, dse.sweep(**port, max_buckets=1)


@pytest.mark.parametrize("spec", SPECS, ids=[pareto.spec_to_str(s)
                                             for s in SPECS])
def test_reduced_sweep_sharded(twelve, spec):
    """Each shard reduces on its device, pad lanes masked; the merged
    candidates equal reduce_oracle over the unsharded lanes, the port's
    unsharded reduced sweep and the reference's."""
    port, ref, lanes = twelve
    got = dse.sweep(**port, max_buckets=4, reduce=spec, mesh=cpu_mesh(8))
    G, B = 2, lanes.latency_cc.shape[0]
    oracle = pareto.reduce_oracle(spec, [t.numpy() for t in lanes],
                                  np.repeat(np.arange(G), B // G),
                                  np.arange(B), G)
    want = ref_dse.sweep(**ref, reduce=ref_pareto.spec_from_str(
        pareto.spec_to_str(spec)))
    _assert_reduced(got, oracle, want)
    _assert_reduced(got, dse.sweep(**port, max_buckets=1, reduce=spec))
    assert int(got.count.sum()) > 0 and not got.clipped.any()


def _dag(mod, n):
    d = mod()
    w = d.const(3 + n)
    for j in range(4 + n):
        t = d.alu("SMUL", d.load(j), w)
        t = d.alu("SADD", t, d.load(16 + j))
        d.store(32 + j, d.alu("SRA", t, d.const(2)))
    return d


@pytest.fixture(scope="module")
def mapping_grid(port_prof, profile):
    """test_mapping_axis.py's candidate sets: 2 DAGs x 3 mappings x 2
    configs x 2 images."""
    ref = [ref_candidates(_dag(RefDAG, g), 3, seed=g, name=f"k{g}")
           for g in range(2)]
    port = [generate_candidates(_dag(DAG, g), 3, seed=g, name=f"k{g}",
                                device="cpu") for g in range(2)]
    rng = np.random.default_rng(0)
    mems = rng.integers(-100, 100, (2, 128)).astype(np.int32)
    kw = dict(mem_images=mems, max_steps=128, mem_size=128, **KNOBS)
    return (dict(kw, mappings=MappingSet.from_candidates(
                [[c.program for c in g] for g in port], names=["k0", "k1"]),
                profile=port_prof, device="cpu", hw_configs=[
                    hwconfig.baseline(),
                    hwconfig.baseline().replace(smul_lat=3)]),
            dict(kw, mappings=RefMappingSet.from_candidates(
                [[c.program for c in g] for g in ref], names=["k0", "k1"]),
                profile=profile, backend="xla", max_buckets=1, hw_configs=[
                    ref_hw.baseline(), ref_hw.baseline().replace(smul_lat=3)]))


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
def test_sweep_mappings_sharded(mapping_grid, fold):
    """The mapping axis is the program axis under sharding too: reduced
    (folded to each kernel's best mapping, or per candidate) and raw
    lanes equal the unsharded answers."""
    port, ref = mapping_grid
    spec = pareto.TopK("edp", 3)
    got = dse.sweep(**port, max_buckets=4, reduce=spec, fold_mappings=fold,
                    mesh=cpu_mesh(8))
    _assert_reduced(got, dse.sweep(**port, max_buckets=1, reduce=spec,
                                   fold_mappings=fold),
                    ref_dse.sweep(**ref, reduce=ref_pareto.TopK("edp", 3),
                                  fold_mappings=fold))
    if not fold:
        _assert_sharded(dse.sweep(**port, max_buckets=4, mesh=cpu_mesh(8)),
                        dse.sweep(**port, max_buckets=1),
                        ref_dse.sweep(**ref))


def test_sweep_on_64_shard_multipod_mesh(port_prof, profile):
    """test_dse_multipod.py: a (pod, data, model) = (2, 4, 8) mesh of 64
    host shards over 65 configs x 8 images = 520 lanes (padded to 576)."""
    k, rk = mibench.bitcnt(n_words=16), ref_mibench.bitcnt(n_words=16)
    mems = np.stack([k.mem_init] * 8)
    topos = list(ALL_TOPOS) * 13
    # short chunks: each of the 64 shards of 9 lanes stops soon after EXIT
    kw = dict(mem_images=mems, max_steps=256, chunk_steps=16, blk_b=32)
    mesh = make_mesh((2, 4, 8), ("pod", "data", "model"),
                     devices=["cpu"] * 64)
    assert mesh.devices.size == 64 and len(mesh.distinct()) == 1
    hws = [hwconfig.TOPOLOGIES[t]() for t in topos]
    got = dse.sweep(k.program, port_prof, hws, mesh=mesh, **kw)
    want = dse.sweep(k.program, port_prof, hws, device="cpu", **kw)
    ref = ref_dse.sweep(rk.program, profile,
                        [ref_hw.TOPOLOGIES[t]() for t in topos],
                        backend="xla", **kw)
    _assert_sharded(got, want, ref)
    lat = got.latency_cc.numpy()
    assert lat.shape == (520,) and (lat > 0).all() and len(set(lat)) > 1


def test_grid_fn_on_mesh_pads_any_slice(twelve):
    """make_grid_fn(mesh=) takes any slice (11 lanes on 4 shards pad to
    12) and places the plan once per distinct device."""
    port, _, lanes = twelve
    plan = dse.plan_grid(programs=port["programs"],
                         hw_configs=port["hw_configs"],
                         mem_images=port["mem_images"], device="cpu")
    fn = dse.make_grid_fn(plan, port["profile"], max_steps=256, **KNOBS,
                          mesh=cpu_mesh(4))
    assert list(fn.images) == [torch.device("cpu")]
    sl = slice(1, 12)
    got = fn(plan.img_idx[sl], plan.hw_grid.map(lambda x: x[sl]),
             plan.prog_idx[sl])
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(lanes, f)[sl]), f
    with pytest.raises(TypeError, match="lane_idx"):
        fn(plan.img_idx, plan.hw_grid, plan.prog_idx, np.arange(12))


# ---------------------------------------------------------------------------
# The runner's elastic re-plan and the elastic restore
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runner_grid(port_prof, profile):
    """test_sweep_service.py's grid: 2 kernels x 5 topologies x 2 images
    = 20 lanes, with both packages' unsharded sweeps."""
    port, ref = _grid(port_prof, profile, THREE[:2], ALL_TOPOS, [0, 1], 256)
    return port, ref, dse.sweep(**port, max_buckets=1), ref_dse.sweep(**ref)


@pytest.mark.parametrize("reduce", [None, SPECS[0]], ids=["full", "topk"])
def test_mesh_runner_replans_to_smaller_mesh(runner_grid, port_prof, reduce,
                                             tmp_path):
    """test_sweep_service.py: 8 shards lose 4 nodes after unit 1, the
    re-plan rebuilds a 4-shard mesh of the survivors, and the stitched
    campaign equals the unsharded sweeps (or the oracle over them)."""
    port, ref, lanes, ref_lanes = runner_grid
    kw = dict(programs=port["programs"], profile=port_prof,
              hw_configs=port["hw_configs"], mem_images=port["mem_images"],
              unit_size=8, max_steps=256, reduce=reduce, **KNOBS)
    t = {"now": 0.0}
    mon = FleetMonitor([f"dev{i}" for i in range(8)],
                       clock=lambda: t["now"], timeout=5.0)
    dead = tuple((1, f"dev{i}") for i in range(4, 8))
    r = ResumableSweepRunner(mesh=cpu_mesh(8), monitor=mon,
                             injector=FaultInjector(FaultPlan(
                                 dead_nodes=dead)),
                             ckpt_dir=str(tmp_path), **kw)
    assert r.n_units == 3 and r._padded_unit == 8
    for k in r.pending_units():
        r.run_unit(k)
        t["now"] += 6.0
    r.mgr.wait()
    assert len(r.report.replans) == 1, r.report.replans
    ev = r.report.replans[0]
    assert ev["dropped"] == [n for _, n in dead] and ev["n_alive"] == 4
    assert ev["elastic_plan"]["n_devices"] == 4
    assert r.mesh.devices.size == 4 and mon.nodes == [
        f"dev{i}" for i in range(4)]
    if reduce is None:
        _assert_sharded(r.stitch(), lanes, ref_lanes)
    else:
        B = lanes.latency_cc.shape[0]
        _assert_reduced(r.stitch(), pareto.reduce_oracle(
            reduce, [x.numpy() for x in lanes],
            np.repeat(np.arange(2), B // 2), np.arange(B), 2),
            ref_dse.sweep(**ref, reduce=ref_pareto.TopK("edp", 3)))
    # a second runner on the same directory resumes every unit
    again = ResumableSweepRunner(mesh=cpu_mesh(8), ckpt_dir=str(tmp_path),
                                 **kw)
    assert again.pending_units() == [] and \
        again.report.units_resumed == 3


Pair = collections.namedtuple("Pair", "lo hi")


def test_restore_resharded_onto_cpu(tmp_path):
    """test_fault_tolerance.py's elastic restore: every leaf placed on
    the device its devices tree names; None keeps the host leaf, one
    device covers a subtree; restore_latest takes the same tree."""
    tree = {"layer": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                      "b": np.arange(3, dtype=np.int32)},
            "span": Pair(np.int64(2), np.arange(4, dtype=np.int64))}
    save_tree(tree, tmp_path, step=1)
    cpu = torch.device("cpu")
    back = restore_resharded(tree, tmp_path / "step_00000001",
                             {"layer": cpu, "span": Pair(None, "cpu")})
    assert isinstance(back["span"], Pair)
    for leaf, want in ((back["layer"]["w"], tree["layer"]["w"]),
                       (back["layer"]["b"], tree["layer"]["b"]),
                       (back["span"].hi, tree["span"].hi)):
        assert isinstance(leaf, torch.Tensor) and leaf.device == cpu
        np.testing.assert_array_equal(leaf.numpy(), want)
    assert isinstance(back["span"].lo, np.ndarray) and back["span"].lo == 2
    with pytest.raises(ValueError, match="no device"):
        restore_resharded(tree, tmp_path / "step_00000001",
                          {"layer": cpu})
    mgr = CheckpointManager(tmp_path)
    got, step = mgr.restore_latest(tree, shardings=cpu)
    assert step == 1 and got["layer"]["w"].device == cpu
    host, _ = mgr.restore_latest(tree)
    assert isinstance(host["layer"]["w"], np.ndarray)


# ---------------------------------------------------------------------------
# The engine's rounds across shards, knobs of a sharded sweep, mesh rules
# ---------------------------------------------------------------------------

def test_shard_rounds_launch_every_shard_before_reading_done(
        twelve, monkeypatch):
    """A round launches one chunk on every unfinished shard and only then
    reads the shards' done flags (no shard's host sync between another's
    launches); one shard is the plain chunk loop, launch for launch.
    The launcher is replaced by the plain chunk, so the rounds run here."""
    port, _, lanes = twelve
    plan = dse.plan_grid(programs=port["programs"],
                         hw_configs=port["hw_configs"],
                         mem_images=port["mem_images"], device="cpu")
    tables = dse.sweep_tables(plan.batch, port["profile"], plan.images.device)
    events = []

    def launcher(tables, hw, gidx, st, *, rows, cols, max_steps, k_steps,
                 blk_b):
        shard = len(events_of)
        events_of.append(st)

        def launch(t0):
            events.append(("launch", shard, t0))
            _chunk(tables, hw, gidx, st, rows=rows, cols=cols, start=t0,
                   k_steps=k_steps, max_steps=max_steps)
        return launch

    monkeypatch.setattr(sweep_ops, "_chunk_launcher", launcher)

    def images(sl):
        return plan.images[torch.as_tensor(plan.img_idx[sl]).long()]

    knobs = dict(rows=4, cols=4, max_steps=256, chunk_steps=16, blk_b=32)

    def shards(parts):
        out = []
        for sl in parts:
            hw = plan.hw_grid.map(lambda x: x[sl].contiguous())
            out.append((tables, hw, torch.as_tensor(plan.prog_idx[sl]),
                        init_lanes(images(sl), 16)))
        return out

    parts = [slice(0, 3), slice(3, 6), slice(6, 12)]
    events_of = []
    jobs = shards(parts)
    counts = sweep_ops._launch_rounds(jobs, **knobs)
    for sl, job in zip(parts, jobs):
        res = dse.lane_results(job[3], port["profile"])
        for f in FIELDS:
            assert torch.equal(getattr(res, f), getattr(lanes, f)[sl]), f
    # rounds: every live shard at t0 before any shard at t0 + 16
    t0s = [e[2] for e in events]
    assert t0s == sorted(t0s)
    for t0 in set(t0s):
        live = [e[1] for e in events if e[2] == t0]
        assert live == sorted(live)
    # each shard alone: the same launches as inside the rounds
    alone = []
    for sl in parts:
        events_of, events[:] = [], []
        job = shards([sl])
        ref_st = init_lanes(images(sl), 16)
        sweep_ref(job[0][0], job[0][1], job[0][2], ref_st, rows=4, cols=4,
                  max_steps=256, chunk_steps=16)
        alone.append(sweep_ops._launch_rounds(job, **knobs)[0])
        assert [e[2] for e in events] == list(range(0, 16 * alone[-1], 16))
        assert torch.equal(job[0][3].t_cc, ref_st.t_cc)
    assert counts == alone and len(set(counts)) > 1


def test_sharded_knobs_resolve_for_the_mesh_width(twelve):
    """A sharded sweep's shape class counts the mesh's entries: a winner
    stored for 8 entries reaches the 8-shard sweep and no other; and
    tune_sweep(mesh=) stores its winner under that width."""
    port, _, _ = twelve
    kw = {k: v for k, v in port.items() if k not in ("chunk_steps", "blk_b")}
    programs = kw.pop("programs")
    cache = default_cache()
    shape = ShapeClass(G=2, t_max=as_program_batch(programs).t_max, H=3,
                       D=2, device="cpu")
    cache.store(dataclasses.replace(shape, n_devices=8),
                TunedConfig(blk_b=16, chunk_steps=32, max_buckets=2,
                            source="tuned"))
    got8 = dse.make_bucketed_sweep_fn(programs, mesh=cpu_mesh(8), **kw).cfg
    got1 = dse.make_bucketed_sweep_fn(programs, **kw).cfg
    assert (got8.source, got8.blk_b, got8.chunk_steps, got8.max_buckets) \
        == ("cache", 16, 32, 2)
    assert got1.source == "default"
    logged = []
    cfg = tune_sweep(programs, kw["profile"], kw["hw_configs"],
                     kw["mem_images"], max_steps=256, device="cpu",
                     mesh=cpu_mesh(4), repeats=1,
                     candidates=[dict(max_buckets=1, chunk_steps=64,
                                      blk_b=32)],
                     log=lambda c, s: logged.append(c))
    assert cfg.source == "tuned" and len(logged) == 1
    assert cache.lookup(dataclasses.replace(shape, n_devices=4)) is not None
    assert cache.lookup(shape) is None


def test_pad_batch_and_flat_shards():
    x = torch.arange(5, dtype=torch.int32) + 10
    assert padded_len(5, 4) == 8 and padded_len(8, 4) == 8
    assert pad_batch(x, 8).tolist() == [10, 11, 12, 13, 14, 10, 10, 10]
    assert pad_batch(x.numpy(), 7, fill=-1).tolist() == \
        [10, 11, 12, 13, 14, -1, -1]
    assert pad_batch(x, 5) is x
    mesh = make_mesh((2, 2), ("a", "b"), devices=["cpu"] * 4)
    assert mesh.shape == {"a": 2, "b": 2}
    assert [(lo, hi) for _, lo, hi in flat_shards(8, mesh)] == \
        [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="pad"):
        flat_shards(6, mesh)


def test_mixed_mesh_raises():
    with pytest.raises(ValueError, match="mix"):
        Mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 2, ("a", "b"))


def test_debug_mesh_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_debug_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((2,), ("data",))
    assert make_debug_mesh(3, device="cpu").devices.size == 3


def test_more_shards_than_cards_raises(monkeypatch):
    """Without a device named, a mesh takes distinct visible cards and
    never repeats one (the CUDA runtime is stubbed to report one card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 visible"):
        mesh_mod.make_debug_mesh(2)
    with pytest.raises(ValueError, match="1 visible"):
        mesh_mod.make_mesh((2, 2), ("a", "b"))
    m = mesh_mod.make_debug_mesh()
    assert [str(d) for d in m.flat()] == ["cuda:0"]


def test_mesh_and_disagreeing_device_raise(twelve):
    port, _, _ = twelve
    kw = dict(port, device="cuda:0")
    with pytest.raises(ValueError, match="disagrees"):
        dse.sweep(**kw, mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="disagrees"):
        ResumableSweepRunner(programs=port["programs"],
                             profile=port["profile"],
                             hw_configs=port["hw_configs"],
                             mem_images=port["mem_images"],
                             device="cuda:0", mesh=cpu_mesh(2))
    # the mesh's own engine agrees
    dse.make_bucketed_sweep_fn(port["programs"], port["profile"],
                               port["hw_configs"], port["mem_images"],
                               device="cpu", mesh=cpu_mesh(2),
                               max_steps=256, **KNOBS)
