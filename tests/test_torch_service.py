"""The port's crash-safe sweep service against the reference: the
checkpoint manager, the resumable runner and the slot server.

Checkpoints keep the reference's on-disk layout, so a step directory
written by either package loads in the other.  The runner's unit
partitions, resumed and retried campaigns and killed-and-resumed
processes must stitch to the port's own ``dse.sweep`` bit for bit and to
the reference's sweep (integers bit for bit, energy and power at rtol
1e-5); a reduced runner to ``reduce_oracle``.  The port's stage chain
has one stage (the kernel, or the plain version when the caller names
the CPU): a persistent fault raises, and a CUDA error is never retried.
The server's packed, streamed, deadline-cut and resumed requests must
equal a solo sweep of each request.
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.analysis import pareto as ref_pareto  # noqa: E402
from repro.apps import mibench as ref_mibench  # noqa: E402
from repro.checkpoint import manager as ref_manager  # noqa: E402
from repro.core import dse as ref_dse, hwconfig as ref_hw  # noqa: E402
from repro.service import ResumableSweepRunner as RefRunner  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis import pareto  # noqa: E402
from repro_torch.apps import mibench  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, load_tree,  # noqa: E402
                                    save_tree)
from repro_torch.core import dse, hwconfig  # noqa: E402
from repro_torch.core.autotune import (ShapeClass, TunedConfig,  # noqa: E402
                                       default_cache)
from repro_torch.runtime import StragglerPolicy  # noqa: E402
from repro_torch.runtime.faults import (FAULT_PLAN_ENV,  # noqa: E402
                                        FaultInjector, FaultPlan)
from repro_torch.service import (CheckpointMismatch,  # noqa: E402
                                 FleetMonitor, ResumableSweepRunner,
                                 RetryPolicy, ServiceOverloaded,
                                 SweepRequest, SweepService, SweepUnitError,
                                 backend_chain)

ROOT = Path(__file__).resolve().parents[1]
MAX_STEPS = 256
TOPOS = ("baseline", "c_interleaved")
DISCRETE = ("latency_cc", "checksum", "steps_executed")
FIELDS = dse.SweepResult._fields


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """AUTO knobs resolve from an empty cache of this module's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "cache.json"))
        yield


def _kernels(mod):
    return [mod.bitcnt(n_words=16), mod.crc32(n_words=3)]


@pytest.fixture(scope="module")
def grid(profile):
    """The reference tests' grid: 2 kernels x 2 topologies x 2 images."""
    rk, pk = _kernels(ref_mibench), _kernels(mibench)
    mems = np.stack([k.mem_init for k in rk])
    port_prof = convert.profile_from_numpy(dataclasses.asdict(profile))
    return dict(programs=[k.program for k in pk], profile=port_prof,
                hw_configs=[hwconfig.TOPOLOGIES[t]() for t in TOPOS],
                mem_images=mems, max_steps=MAX_STEPS, device="cpu")


@pytest.fixture(scope="module")
def ref_grid(profile):
    rk = _kernels(ref_mibench)
    return dict(programs=[k.program for k in rk], profile=profile,
                hw_configs=[ref_hw.TOPOLOGIES[t]() for t in TOPOS],
                mem_images=np.stack([k.mem_init for k in rk]),
                max_steps=MAX_STEPS)


@pytest.fixture(scope="module")
def mono(grid):
    """The port's uninterrupted single-call sweep (B = 8)."""
    return dse.sweep(**grid)


@pytest.fixture(scope="module")
def ref_mono(ref_grid):
    """The reference's single-call sweep, its knobs pinned."""
    return ref_dse.sweep(**ref_grid, backend="xla", chunk_steps=64, blk_b=32,
                         max_buckets=1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(a, b, fields=FIELDS):
    for f in fields:
        got, want = _np(getattr(a, f)), _np(getattr(b, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _assert_matches_ref(ref, res):
    _assert_same(ref, res, DISCRETE)
    for f in ("energy_pj", "power_mw"):
        np.testing.assert_allclose(_np(getattr(res, f)),
                                   _np(getattr(ref, f)), rtol=1e-5,
                                   err_msg=f)


def _runner(grid, **kw):
    return ResumableSweepRunner(**grid, **kw)


# ---------------------------------------------------------------------------
# Checkpoints: the reference's layout, readable by both packages
# ---------------------------------------------------------------------------

Pair = collections.namedtuple("Pair", "lo hi")


def _tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [np.arange(4, dtype=np.int32), (np.float32(0.5), None)],
            "span": Pair(np.int64(3), torch.tensor([7, 8]))}


def _like(tree):
    return {"w": np.zeros((2, 3), np.float32),
            "b": [np.zeros(4, np.int32), (np.float32(0), None)],
            "span": Pair(np.int64(0), np.zeros(2, np.int64))}


def _assert_tree(got, tree):
    assert isinstance(got["span"], Pair) and got["b"][1][1] is None
    np.testing.assert_array_equal(got["w"], tree["w"].numpy())
    np.testing.assert_array_equal(got["b"][0], tree["b"][0])
    assert got["b"][1][0] == tree["b"][1][0]
    assert got["span"].lo == 3
    np.testing.assert_array_equal(got["span"].hi, [7, 8])


def test_checkpoint_layout_loads_in_both_packages(tmp_path):
    """The port's step directory has the reference's manifest keys and
    files and loads with the reference's load_tree; a reference step
    directory loads with the port's."""
    tree = _tree()
    port_dir = save_tree(tree, tmp_path / "port", step=3,
                         extra={"k": 1})
    ref_dir = ref_manager.save_tree(
        {"w": tree["w"].numpy(), "b": tree["b"],
         "span": Pair(np.int64(3), np.array([7, 8]))},
        tmp_path / "ref", step=3, extra={"k": 1})
    assert port_dir.name == ref_dir.name == "step_00000003"
    pm = json.loads((port_dir / "manifest.json").read_text())
    rm = json.loads((ref_dir / "manifest.json").read_text())
    assert list(pm["leaves"]) == list(rm["leaves"])
    assert pm["leaves"] == rm["leaves"]
    assert sorted(p.name for p in port_dir.iterdir()) \
        == sorted(p.name for p in ref_dir.iterdir())
    _assert_tree(ref_manager.load_tree(_like(tree), port_dir), tree)
    _assert_tree(load_tree(_like(tree), ref_dir), tree)
    with pytest.raises(ValueError, match="shape"):
        load_tree({**_like(tree), "w": np.zeros(3)}, port_dir)


def test_checkpoint_atomic_retention_and_async(tmp_path):
    """A leftover .tmp directory is not a step; keep_n retains the newest
    steps; an async save snapshots tensors before its thread runs, so a
    later in-place update does not reach the file."""
    mgr = CheckpointManager(tmp_path, keep_n=2)
    (tmp_path / "step_00000009.tmp").mkdir()
    assert mgr.steps() == [] and mgr.restore_latest(_like(_tree())) \
        == (None, None)
    for step in range(4):
        t = torch.full((3,), float(step))
        mgr.save({"t": t}, step, block=False)
        t.fill_(-1.0)                      # after the snapshot
    mgr.wait()
    assert mgr.steps() == [2, 3]
    got, step = mgr.restore_latest({"t": np.zeros(3, np.float32)})
    assert step == 3
    np.testing.assert_array_equal(got["t"], [3.0, 3.0, 3.0])


def test_checkpoint_async_error_surfaces_at_wait(tmp_path):
    """A save that fails on its thread raises at the next wait."""
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "step_00000001.tmp").write_text("not a directory")
    mgr.save({"t": np.zeros(2)}, 1, block=False)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                            # the error is raised once


# ---------------------------------------------------------------------------
# Partitioned execution == monolithic execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unit_size", [1, 3, 8, 64])
def test_unit_partition_matches_monolithic(grid, mono, ref_mono, unit_size):
    """Any unit partition (ragged tail and padded units included)
    stitches to the port's monolithic sweep bit for bit and to the
    reference's within its contract."""
    res, rep = _runner(grid, unit_size=unit_size).run()
    _assert_same(mono, res)
    _assert_matches_ref(ref_mono, res)
    assert rep.units_run == rep.units_total == -(-8 // unit_size)
    assert all(r.backend == "plain" for r in rep.records)


def test_reduced_runner_matches_oracle_and_reference(grid, mono, ref_grid):
    """Every unit reduces on the device and checkpoints its candidate
    set; the merged answer equals reduce_oracle over the monolithic
    lanes, bit for bit, and the reference's reduced runner."""
    spec = pareto.TopK("edp", k=3)
    got, _ = _runner(grid, unit_size=3, reduce=spec).run()
    B = 8
    want = pareto.reduce_oracle(spec, [x.numpy() for x in mono],
                                np.repeat(np.arange(2), B // 2),
                                np.arange(B), 2)
    for f in pareto.REDUCED_FIELDS:
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
    ref, _ = RefRunner(**ref_grid, unit_size=3,
                       reduce=ref_pareto.TopK("edp", k=3), backend="xla",
                       chunk_steps=64, blk_b=32).run()
    for f in ("indices", "count", "clipped") + DISCRETE:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_runner_knobs_resolve_through_the_autotune_cache(grid, mono):
    """AUTO blk_b / chunk_steps come from the lane-shape proxy's cache
    entry; explicit knobs win; neither changes a result."""
    plan = dse.plan_grid(programs=grid["programs"],
                         hw_configs=grid["hw_configs"],
                         mem_images=grid["mem_images"], device="cpu")
    shape = ShapeClass(G=2, t_max=plan.batch.t_max, H=4, D=1, device="cpu")
    default_cache().store(shape, TunedConfig(blk_b=8, chunk_steps=16,
                                             max_buckets=1))
    kw = {k: v for k, v in grid.items()
          if k in ("profile", "max_steps")}
    r = ResumableSweepRunner(plan=plan, unit_size=3, **kw)
    assert (r.blk_b, r.chunk_steps, r.tuned_source) == (8, 16, "cache")
    pinned = ResumableSweepRunner(plan=plan, unit_size=3, blk_b=32,
                                  chunk_steps=64, **kw)
    assert pinned.tuned_source == "explicit"
    assert pinned.fingerprint != r.fingerprint
    _assert_same(mono, r.run()[0])
    with pytest.raises(TypeError, match="plan"):
        ResumableSweepRunner(plan=plan, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------

def test_resume_skips_completed_units(grid, mono, tmp_path):
    r1 = _runner(grid, ckpt_dir=str(tmp_path), unit_size=3)
    r1.run_unit(0)
    r1.run_unit(1)
    r1.mgr.wait()
    r2 = _runner(grid, ckpt_dir=str(tmp_path), unit_size=3)
    assert r2.pending_units() == [2]
    res, rep = r2.run()
    assert rep.units_resumed == 2 and rep.units_run == 1
    assert [r.resumed for r in rep.records] == [True, True, False]
    _assert_same(mono, res)


def test_unit_checkpoints_load_in_both_packages(grid, ref_grid, tmp_path):
    """A unit directory written by the port's runner loads with the
    reference's load_tree, and the reference runner's with the port's:
    the same lanes either way."""
    port = _runner(grid, ckpt_dir=str(tmp_path / "port"), unit_size=3,
                   ckpt_async=False)
    port.run()
    ref = RefRunner(**ref_grid, ckpt_dir=str(tmp_path / "ref"),
                    unit_size=3, backend="xla", chunk_steps=64, blk_b=32,
                    ckpt_async=False)
    ref.run()
    like = {f: np.zeros(3, np.int32 if f in DISCRETE else np.float32)
            for f in FIELDS}
    for k in (0, 1):
        mine = ref_manager.load_tree(like, port.mgr.path(k))
        theirs = load_tree(like, ref.mgr.path(k))
        for f in DISCRETE:
            np.testing.assert_array_equal(mine[f], theirs[f], err_msg=f)
        for f in ("energy_pj", "power_mw"):
            np.testing.assert_allclose(mine[f], theirs[f], rtol=1e-5)


def test_checkpoint_fingerprint_mismatch_refused(grid, tmp_path):
    r1 = _runner(grid, ckpt_dir=str(tmp_path), unit_size=3)
    r1.run_unit(0)
    r1.mgr.wait()
    other = dict(grid, max_steps=MAX_STEPS // 2)
    with pytest.raises(CheckpointMismatch, match="fingerprint"):
        _runner(other, ckpt_dir=str(tmp_path), unit_size=3)


# ---------------------------------------------------------------------------
# Retry / backoff; one stage, no fallback
# ---------------------------------------------------------------------------

def test_transient_faults_absorbed_by_retry(grid, mono):
    sleeps = []
    inj = FaultInjector(FaultPlan(seed=3, transient_rate=1.0,
                                  max_transient_per_unit=2))
    r = _runner(grid, unit_size=3, injector=inj, sleep=sleeps.append,
                retry=RetryPolicy(max_attempts=3, backoff_s=0.01,
                                  backoff_mult=2.0))
    res, rep = r.run()
    _assert_same(mono, res)
    assert rep.attempts_total == 3 * rep.units_total
    assert sleeps == [0.01, 0.02] * rep.units_total


def test_retry_exhaustion_raises(grid):
    inj = FaultInjector(FaultPlan(transient_rate=1.0,
                                  max_transient_per_unit=99))
    r = _runner(grid, unit_size=3, injector=inj, sleep=lambda s: None,
                retry=RetryPolicy(max_attempts=2))
    with pytest.raises(SweepUnitError, match="every backend"):
        r.run()
    assert r.report.attempts_total == 2


def test_stage_chain_has_one_stage():
    assert [s.name for s in backend_chain("cpu")] == ["plain"]
    if torch.cuda.is_available():
        assert [s.name for s in backend_chain("cuda")] == ["cuda"]
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            backend_chain(None)


def test_persistent_fault_raises_without_fallback(grid):
    """A persistent fault on the only stage raises SweepUnitError at
    once: nothing falls back to another engine.  (The reference degrades
    pallas -> interpreter -> xla instead.)"""
    inj = FaultInjector(FaultPlan(broken_backends=("plain",)))
    r = _runner(grid, unit_size=3, injector=inj, sleep=lambda s: None)
    with pytest.raises(SweepUnitError, match="injected persistent"):
        r.run()
    assert r.report.attempts_total == 1 and r.report.units_run == 0
    # a fault injected for the card's stage never fires on the host
    inj = FaultInjector(FaultPlan(broken_backends=("cuda",)))
    _runner(grid, unit_size=8, injector=inj).run()


def test_cuda_error_is_not_retried(grid, monkeypatch):
    """A CUDA error may leave the context unusable: it propagates on the
    first attempt, neither retried nor wrapped."""
    r = _runner(grid, unit_size=3, sleep=lambda s: None)
    calls = []

    def poisoned(*args):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    monkeypatch.setattr(r, "_grid_fn", lambda: poisoned)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        r.run_unit(0)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# Fleet wiring: heartbeats -> replan; stragglers -> rebalance
# ---------------------------------------------------------------------------

def test_dead_node_triggers_replan_and_exact_result(grid, mono):
    t = {"now": 0.0}
    mon = FleetMonitor(["w0", "w1"], clock=lambda: t["now"], timeout=5.0)
    inj = FaultInjector(FaultPlan(dead_nodes=((1, "w1"),)))
    r = _runner(grid, unit_size=2, monitor=mon, injector=inj)
    for k in r.pending_units():
        r.run_unit(k)
        t["now"] += 6.0
    assert r.report.replans[0]["dropped"] == ["w1"]
    assert r.report.replans[0]["n_alive"] == 1
    assert mon.nodes == ["w0"]
    _assert_same(mono, r.stitch())


def test_all_workers_dead_raises(grid):
    t = {"now": 0.0}
    mon = FleetMonitor(["w0"], clock=lambda: t["now"], timeout=5.0)
    inj = FaultInjector(FaultPlan(dead_nodes=((0, "w0"),)))
    r = _runner(grid, unit_size=2, monitor=mon, injector=inj)
    r.run_unit(0)
    t["now"] = 10.0
    with pytest.raises(SweepUnitError, match="every worker"):
        r.run_unit(1)


def test_straggler_feeds_unit_size_rebalance(grid):
    mon = FleetMonitor(["w0", "w1", "w2"],
                       policy=StragglerPolicy(persistent_k=2,
                                              min_samples=3))
    inj = FaultInjector(FaultPlan(slow_units=(1,), slow_extra_s=50.0))
    _, rep = _runner(grid, unit_size=2, monitor=mon, injector=inj).run()
    acts = [(a["node"], a["action"]) for a in rep.straggler_actions]
    assert ("w1", "rebalance") in acts and ("w1", "replace") in acts
    assert rep.suggested_unit_size == 1


# ---------------------------------------------------------------------------
# Kill-and-resume (subprocess, SIGKILL)
# ---------------------------------------------------------------------------

def _cli(out, extra_args=(), fault_plan=None) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               # one intra-op thread: the test workers share the cores
               OMP_NUM_THREADS="1")
    env.pop(FAULT_PLAN_ENV, None)
    if fault_plan is not None:
        env[FAULT_PLAN_ENV] = fault_plan.to_json()
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", "--device", "cpu",
         "--kernels", "bitcnt,crc32", "--unit-size", "3",
         "--max-steps", str(MAX_STEPS), "--out", str(out), *extra_args],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen):
    _, err = proc.communicate(timeout=120)
    return proc.returncode, err


def test_sigkill_midsweep_resumes_bit_identical(tmp_path, ref_mono):
    """SIGKILL right before a unit's checkpoint commit; a fresh process
    resumes the two committed units, and the stitched result equals an
    uninterrupted run (run beside the killed one) bit for bit, and the
    reference's sweep."""
    ck = str(tmp_path / "ck")
    killed = _cli(tmp_path / "dead.npz", ["--ckpt-dir", ck],
                  FaultPlan(kill_at_unit=2))
    solo = _cli(tmp_path / "solo.npz")
    rc, err = _finish(killed)
    assert rc == -9, (rc, err)
    assert not (tmp_path / "dead.npz").exists()
    rc, err = _finish(solo)
    assert rc == 0, err

    rep_out = tmp_path / "rep.json"
    rc, err = _finish(_cli(tmp_path / "resumed.npz",
                           ["--ckpt-dir", ck, "--report-out", str(rep_out)]))
    assert rc == 0, err
    rep = json.loads(rep_out.read_text())
    assert rep["units_resumed"] == 2 and rep["units_run"] == 1

    a = np.load(tmp_path / "resumed.npz")
    b = np.load(tmp_path / "solo.npz")
    assert sorted(a.files) == sorted(FIELDS)
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    _assert_matches_ref(ref_mono, dse.SweepResult(
        **{f: torch.from_numpy(a[f]) for f in FIELDS}))


# ---------------------------------------------------------------------------
# Sweep service: packing, streaming, backpressure, deadlines, resume
# ---------------------------------------------------------------------------

def _requests(grid):
    ks = _kernels(mibench)
    hws, mems = grid["hw_configs"], grid["mem_images"]
    return (SweepRequest(programs=[ks[0].program], hw_configs=hws,
                         mem_images=mems[:1]),
            SweepRequest(programs=[ks[1].program], hw_configs=hws,
                         mem_images=mems[1:]))


def _service(grid, **kw):
    kw.setdefault("unit_size", 2)
    return SweepService(grid["profile"], max_steps=MAX_STEPS, device="cpu",
                        **kw)


def _solo(grid, req, **kw):
    return dse.sweep(programs=list(req.programs), profile=grid["profile"],
                     hw_configs=req.hw_configs, mem_images=req.mem_images,
                     max_steps=MAX_STEPS, device="cpu", **kw)


def test_service_packs_requests_and_matches_solo(grid, ref_mono):
    """Two requests packed into one merged campaign each get exactly the
    result of a solo sweep of their own sub-grid; together they are the
    reference's lanes of those design points."""
    r1, r2 = _requests(grid)
    svc = _service(grid, slots=1, max_buckets=1)
    svc.submit(r1)
    svc.submit(r2)
    out = svc.drain()
    assert set(out) == {r1.rid, r2.rid}
    assert svc.admission_log[0]["rids"] == [r1.rid, r2.rid]
    for req in (r1, r2):
        got = out[req.rid]
        assert not got.expired and got.skipped_lanes == 0
        solo = _solo(grid, req)
        for f in FIELDS:
            np.testing.assert_array_equal(got.arrays[f],
                                          getattr(solo, f).numpy(),
                                          err_msg=f)
    # request g's lanes (h, d=g) are rows (g*2 + h)*2 + g of the grid
    for g, req in enumerate((r1, r2)):
        rows = [(g * 2 + h) * 2 + g for h in range(2)]
        for f in DISCRETE:
            np.testing.assert_array_equal(
                out[req.rid].arrays[f],
                np.asarray(getattr(ref_mono, f))[rows], err_msg=f)


def test_service_reduced_request_matches_solo_and_reference(grid, ref_grid):
    spec = pareto.TopK("edp", k=2)
    req = SweepRequest(programs=grid["programs"],
                       hw_configs=grid["hw_configs"],
                       mem_images=grid["mem_images"], reduce=spec)
    svc = _service(grid, slots=1, unit_size=3)
    rid = svc.submit(req)
    got = svc.drain()[rid].arrays
    want = _solo(grid, req, reduce=spec)
    for f in pareto.REDUCED_FIELDS:
        assert got[f].tobytes() == getattr(want, f).tobytes(), f
    ref = ref_dse.sweep(**ref_grid, reduce=ref_pareto.TopK("edp", k=2),
                        backend="xla", chunk_steps=64, blk_b=32,
                        max_buckets=1)
    for f in ("indices", "count") + DISCRETE:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_service_streams_partials(grid):
    parts = []
    r1, r2 = _requests(grid)        # 2 lanes each (1 prog x 2 hw x 1 img)
    r1.on_partial = lambda rid, lo, hi, p: parts.append((rid, lo, hi))
    svc = _service(grid, slots=1, unit_size=1)
    svc.submit(r1)
    svc.submit(r2)
    out = svc.drain()
    assert parts == [(r1.rid, 0, 1), (r1.rid, 1, 2)]
    assert set(out) == {r1.rid, r2.rid}


def test_service_backpressure(grid):
    r1, r2 = _requests(grid)
    svc = _service(grid, slots=1, queue_max=1)
    svc.submit(r1)
    with pytest.raises(ServiceOverloaded):
        svc.submit(r2)


def test_service_deadline_skips_only_expired_request(grid):
    t = {"now": 0.0}
    r1, r2 = _requests(grid)
    r1.mem_images = grid["mem_images"]    # 4 lanes: two units
    r1.deadline_s = 0.5
    svc = _service(grid, slots=1, clock=lambda: t["now"])
    svc.submit(r1)
    svc.submit(r2)
    svc.step()                            # r1's first unit
    t["now"] = 1.0                        # r1 is now past its deadline
    out = svc.drain()
    got1, got2 = out[r1.rid], out[r2.rid]
    assert got1.expired and got1.skipped_lanes == 2
    assert np.all(got1.arrays["latency_cc"][2:] == 0)
    assert np.any(got1.arrays["latency_cc"][:2] != 0)
    assert not got2.expired
    np.testing.assert_array_equal(got2.arrays["latency_cc"],
                                  _solo(grid, r2).latency_cc.numpy())


def test_service_ckpt_root_resumes_completed_units(grid, mono, tmp_path):
    """An identical re-submission against the same checkpoint root
    replays its checkpointed units' partials at admission and computes
    only the rest."""
    root = str(tmp_path / "ck")

    def request(partials):
        return SweepRequest(
            programs=grid["programs"], hw_configs=grid["hw_configs"],
            mem_images=grid["mem_images"],
            on_partial=lambda rid, lo, hi, a: partials.append((lo, hi)))

    s1 = _service(grid, ckpt_root=root)
    p1 = []
    s1.submit(request(p1))
    s1.step()
    s1.step()
    s1._slots[0].runner.mgr.wait()
    assert p1 == [(0, 2), (2, 4)]

    s2 = _service(grid, ckpt_root=root)
    p2 = []
    rid = s2.submit(request(p2))
    s2.step()
    assert p2 == [(0, 2), (2, 4), (4, 6)]
    res = s2.drain()[rid]
    assert sorted(set(p2)) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    for f in FIELDS:
        np.testing.assert_array_equal(res.arrays[f],
                                      getattr(mono, f).numpy(), err_msg=f)


def test_steps_history_lru_bounded(grid):
    svc = _service(grid, steps_history_max=2)
    svc.steps_history["a"] = 10
    svc.steps_history["b"] = 20
    svc._record_steps(
        SweepRequest(programs=grid["programs"][:1],
                     hw_configs=grid["hw_configs"],
                     mem_images=grid["mem_images"][:1]),
        {"steps_executed": np.full((2,), 7, np.int32)}, reduced=False)
    name0 = grid["programs"][0].name
    assert list(svc.steps_history) == ["b", name0]
    svc.steps_history.move_to_end("b")
    svc._record_steps(
        SweepRequest(programs=grid["programs"][1:],
                     hw_configs=grid["hw_configs"],
                     mem_images=grid["mem_images"][:1]),
        {"steps_executed": np.full((2,), 9, np.int32)}, reduced=False)
    assert list(svc.steps_history) == ["b", grid["programs"][1].name]
