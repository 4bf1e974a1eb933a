"""The port's autotune cache and AUTO knobs against the reference.

``core.autotune`` keeps the reference's cache discipline -- round trip,
corrupt, stale or malformed entries dropped, explicit knobs beat the
cache, the environment override, read-merge-write under a file lock
with a timeout fallback -- under its own file and variables, with the
device type (``"cuda"`` / ``"cpu"``) as the shape class's device axis.
``resolve`` must fill knobs as the reference's does.  A sweep whose
knobs resolve through the cache (or are tuned first) must equal the
fixed-knob sweep and the reference's sweep: integers bit for bit,
energy and power at rtol 1e-5.  Every test points
``REPRO_TORCH_AUTOTUNE_CACHE`` (and the reference's variable) at
``tmp_path``.
"""
import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.apps import mibench as ref_mibench  # noqa: E402
from repro.core import autotune as ref_autotune  # noqa: E402
from repro.core import dse as ref_dse, hwconfig as ref_hw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import mibench  # noqa: E402
from repro_torch.core import dse, hwconfig  # noqa: E402
from repro_torch.core.autotune import (AUTO, AutotuneCache,  # noqa: E402
                                       ShapeClass, TunedConfig,
                                       default_cache, default_candidates,
                                       tune_sweep)

MAX_STEPS = 128
TOPOS = ("baseline", "c_interleaved")
INT_FIELDS = ("latency_cc", "checksum", "steps_executed")
_SHAPE = ShapeClass(G=4, t_max=8, H=5, D=2, device="cpu")
_REF_SHAPE = ref_autotune.ShapeClass(G=4, t_max=8, H=5, D=2, backend="xla")


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    """Both packages' default caches live under this test's tmp_path."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "port-default.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE",
                       str(tmp_path / "ref-default.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)


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


@pytest.fixture(scope="module")
def ref_lanes(grid):
    """The reference's sweep of the grid, its knobs pinned."""
    res = ref_dse.sweep(**grid["ref"], backend="xla", chunk_steps=64,
                        blk_b=32, max_buckets=1)
    return [np.asarray(x) for x in res]


def _assert_lanes(got, want):
    for f, g, w in zip(dse.SweepResult._fields, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        if f in INT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f)


def _grid_shape(grid) -> ShapeClass:
    from repro_torch.core.program import pack_programs
    p = grid["port"]
    return ShapeClass(G=len(p["programs"]),
                      t_max=pack_programs(p["programs"]).t_max,
                      H=len(p["hw_configs"]), D=p["mem_images"].shape[0],
                      device="cpu")


# ---------------------------------------------------------------------------
# The cache: round trip, tolerant load, resolve precedence
# ---------------------------------------------------------------------------

def test_cache_roundtrips(tmp_path):
    path = tmp_path / "autotune.json"
    c1 = AutotuneCache(path)
    assert c1.lookup(_SHAPE) is None
    c1.store(_SHAPE, TunedConfig(blk_b=16, chunk_steps=32, max_buckets=2,
                                 source="tuned", points_per_s=123.0))
    got = AutotuneCache(path).lookup(_SHAPE)       # fresh load from disk
    assert (got.blk_b, got.chunk_steps, got.max_buckets) == (16, 32, 2)
    assert got.source == "cache" and got.points_per_s == 123.0
    r = AutotuneCache(path).resolve(_SHAPE)
    assert (r.blk_b, r.chunk_steps, r.max_buckets, r.source) \
        == (16, 32, 2, "cache")
    entry = json.loads(path.read_text())["entries"][_SHAPE.key]
    assert entry["device"] == "cpu"
    # chunk_steps=None ("one chunk of max_steps") survives the round trip
    c1.store(_SHAPE, TunedConfig(blk_b=8, chunk_steps=None, max_buckets=1,
                                 source="tuned"))
    assert AutotuneCache(path).lookup(_SHAPE).chunk_steps is None


def test_cache_corrupt_stale_or_malformed_is_dropped(tmp_path):
    """Unreadable, invalid, wrong-version and malformed caches degrade to
    the static defaults -- never fatal; an entry without one of the
    port's device types (a reference entry, say) is malformed."""
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{this is not json")
    c = AutotuneCache(corrupt)
    assert c.resolve(_SHAPE).source == "default"
    c.store(_SHAPE, TunedConfig(blk_b=8, chunk_steps=16, max_buckets=1,
                                source="tuned"))
    assert AutotuneCache(corrupt).lookup(_SHAPE).blk_b == 8

    good = {"blk_b": 8, "chunk_steps": 16, "max_buckets": 1,
            "device": "cpu"}
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"version": 999,
                                 "entries": {_SHAPE.key: good}}))
    assert AutotuneCache(stale).entries == {}

    bad = [dict(good, blk_b="wat"), dict(good, blk_b=0),
           dict(good, chunk_steps=True), dict(good, max_buckets=None),
           dict(good, points_per_s="fast"), dict(good, device="tpu"),
           {k: v for k, v in good.items() if k != "device"},
           dict({k: v for k, v in good.items() if k != "device"},
                backend="xla")]
    for i, e in enumerate(bad):
        p = tmp_path / f"malformed{i}.json"
        p.write_text(json.dumps({"version": 1, "entries": {
            _SHAPE.key: e, "other": good}}))
        assert list(AutotuneCache(p).entries) == ["other"], e


def test_reference_cache_file_never_feeds_the_port(tmp_path):
    """The reference's own cache file, read by the port, yields nothing:
    its entries carry a backend, not a device type."""
    path = tmp_path / "shared.json"
    ref_autotune.AutotuneCache(path).store(_REF_SHAPE, ref_autotune.
                                           TunedConfig(blk_b=16,
                                                       chunk_steps=32,
                                                       max_buckets=2))
    assert AutotuneCache(path).entries == {}


@pytest.mark.parametrize("knobs", [
    {}, dict(blk_b=4), dict(chunk_steps=None), dict(max_buckets=1),
    dict(blk_b=4, chunk_steps=None, max_buckets=1),
    dict(chunk_steps=128, max_buckets=3)])
@pytest.mark.parametrize("cached", [False, True])
def test_resolve_matches_reference(tmp_path, knobs, cached):
    """Explicit knobs win, AUTO ones fill from the cache, else the
    defaults -- knob for knob and source for source as the reference."""
    port = AutotuneCache(tmp_path / "port.json")
    ref = ref_autotune.AutotuneCache(tmp_path / "ref.json")
    if cached:
        port.store(_SHAPE, TunedConfig(blk_b=16, chunk_steps=32,
                                       max_buckets=2, source="tuned"))
        ref.store(_REF_SHAPE, ref_autotune.TunedConfig(
            blk_b=16, chunk_steps=32, max_buckets=2, source="tuned"))
    got = port.resolve(_SHAPE, **knobs)
    want = ref.resolve(_REF_SHAPE, **knobs)
    assert (got.blk_b, got.chunk_steps, got.max_buckets, got.source) \
        == (want.blk_b, want.chunk_steps, want.max_buckets, want.source)


def test_default_cache_follows_env_and_home(tmp_path, monkeypatch):
    target = tmp_path / "env-cache.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(target))
    assert default_cache().path == target
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert default_cache().path == (tmp_path / "home" / ".cache"
                                    / "repro_torch" / "autotune.json")


def test_shape_class_keys_on_the_device_type(tmp_path):
    with pytest.raises(ValueError, match="device"):
        ShapeClass(G=1, t_max=1, H=1, D=1, device="xla")
    cuda = dataclasses.replace(_SHAPE, device="cuda")
    assert cuda.key != _SHAPE.key and "-cuda-" in cuda.key
    c = AutotuneCache(tmp_path / "c.json")
    c.store(_SHAPE, TunedConfig(blk_b=16, chunk_steps=32, max_buckets=2))
    # a winner timed on the host never feeds the card
    assert c.lookup(cuda) is None and c.resolve(cuda).source == "default"


def test_default_candidates():
    cuda = ShapeClass(G=4, t_max=8, H=5, D=2, device="cuda")
    cands = default_candidates(cuda, max_steps=2048)
    assert {c["max_buckets"] for c in cands} == {1, 2, 4}
    assert {c["chunk_steps"] for c in cands} == {32, 64, 128}
    assert {c["blk_b"] for c in cands} == {16, 32, 64}
    assert len(cands) == 27
    big = dataclasses.replace(cuda, G=12)
    assert {c["max_buckets"]
            for c in default_candidates(big, 2048)} == {1, 2, 4, 8}
    # blk_b * P stays within the kernel's 1024 threads a block
    assert {c["blk_b"]
            for c in default_candidates(cuda, 2048, n_pes=32)} == {16, 32}
    # the plain version has no blocks: one width; short runs, short chunks
    cpu = default_candidates(_SHAPE, max_steps=40)
    assert {c["blk_b"] for c in cpu} == {32}
    assert {c["chunk_steps"] for c in cpu} == {32}


# ---------------------------------------------------------------------------
# AUTO knobs on the sweep: bit-identical to fixed knobs and the reference
# ---------------------------------------------------------------------------

def test_tune_sweep_persists_winner_and_sweep_consults_it(grid, ref_lanes):
    """tune_sweep times the candidates, stores the winner under the
    sweep's shape class, and a later AUTO sweep runs with it (source
    "cache"), equal to the fixed-knob sweep and the reference."""
    p = grid["port"]
    timed = []
    cfg = tune_sweep(p["programs"], p["profile"], p["hw_configs"],
                     p["mem_images"], max_steps=MAX_STEPS, device="cpu",
                     candidates=[
                         dict(max_buckets=1, chunk_steps=16, blk_b=4),
                         dict(max_buckets=2, chunk_steps=24, blk_b=4)],
                     repeats=1, log=lambda c, s: timed.append((c, s)))
    assert cfg.source == "tuned" and cfg.points_per_s > 0
    assert [c["chunk_steps"] for c, _ in timed] == [16, 24]
    assert all(s > 0 for _, s in timed)
    hit = default_cache().lookup(_grid_shape(grid))
    assert hit is not None and (hit.chunk_steps, hit.max_buckets) \
        == (cfg.chunk_steps, cfg.max_buckets)
    held = dse.make_bucketed_sweep_fn(**p, device="cpu")
    assert held.cfg.source == "cache"
    assert (held.cfg.chunk_steps, held.cfg.blk_b, held.cfg.max_buckets) \
        == (cfg.chunk_steps, 4, cfg.max_buckets)
    tuned = dse.sweep(**p, device="cpu")
    pinned = dse.sweep(**p, device="cpu", chunk_steps=None, blk_b=4,
                       max_buckets=1)
    for f in dse.SweepResult._fields:
        assert torch.equal(getattr(tuned, f), getattr(pinned, f)), f
    _assert_lanes(tuned, ref_lanes)


@pytest.mark.parametrize("entry", [
    dict(blk_b=16, chunk_steps=32, max_buckets=1),
    dict(blk_b=64, chunk_steps=None, max_buckets=4),
    dict(blk_b=32, chunk_steps=128, max_buckets=2)])
def test_cached_knobs_do_not_change_the_sweep(grid, ref_lanes, entry):
    p = grid["port"]
    default_cache().store(_grid_shape(grid), TunedConfig(**entry))
    fn = dse.make_bucketed_sweep_fn(**p, device="cpu")
    assert fn.cfg.source == "cache"
    assert fn.buckets.n_buckets <= entry["max_buckets"]
    got = fn()
    fixed = dse.sweep(**p, device="cpu", chunk_steps=64, blk_b=32,
                      max_buckets=4)
    for f in dse.SweepResult._fields:
        assert torch.equal(getattr(got, f), getattr(fixed, f)), f
    _assert_lanes(got, ref_lanes)


def test_autotune_env_tunes_an_unseen_shape_once(grid, ref_lanes,
                                                 monkeypatch):
    """REPRO_TORCH_AUTOTUNE=1: the first AUTO sweep of an untuned shape
    times the candidate grid and persists the winner; pinned knobs never
    trigger tuning; the result is unchanged."""
    p = dict(grid["port"], max_steps=40)
    shape = _grid_shape(grid)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    dse.sweep(**p, device="cpu", chunk_steps=64, blk_b=32, max_buckets=4)
    assert default_cache().lookup(shape) is None
    fn = dse.make_bucketed_sweep_fn(**p, device="cpu")
    assert fn.cfg.source == "tuned"
    assert default_cache().lookup(shape) is not None
    again = dse.make_bucketed_sweep_fn(**p, device="cpu")
    assert again.cfg.source == "cache"
    want = dse.sweep(**p, device="cpu", chunk_steps=64, blk_b=32,
                     max_buckets=1)
    got = fn()
    for f in dse.SweepResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---------------------------------------------------------------------------
# Concurrent writers: read-merge-write under the file lock
# ---------------------------------------------------------------------------

def _cfg(n):
    return TunedConfig(blk_b=16 + n, chunk_steps=32, max_buckets=2,
                       source="tuned", points_per_s=1.0)


def _shape(n):
    return ShapeClass(G=n, t_max=8, H=2, D=2, device="cuda")


def test_save_merges_concurrent_writers(tmp_path):
    """Two caches loaded before either saved keep each other's entries."""
    path = tmp_path / "autotune.json"
    c1, c2 = AutotuneCache(path), AutotuneCache(path)   # both load empty
    c1.store(_shape(1), _cfg(1))
    c2.store(_shape(2), _cfg(2))
    on_disk = AutotuneCache(path)
    assert _shape(1).key in on_disk.entries
    assert _shape(2).key in on_disk.entries
    assert _shape(1).key in c2.entries      # the merge warmed c2 too


def test_racing_writers_keep_every_entry(tmp_path):
    """More writer threads than cores, a short switch interval and
    interleaved saves: every entry survives."""
    path = tmp_path / "autotune.json"
    n_threads, per_thread = (os.cpu_count() or 1) + 2, 6

    def writer(base):
        cache = AutotuneCache(path, lock_timeout_s=30.0)
        for i in range(per_thread):
            cache.store(_shape(base + i), _cfg(i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=writer, args=(100 * (b + 1),))
              for b in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    final = AutotuneCache(path)
    missing = [100 * (b + 1) + i for b in range(n_threads)
               for i in range(per_thread)
               if _shape(100 * (b + 1) + i).key not in final.entries]
    assert not missing, f"racing writers dropped entries: {missing}"


def test_lock_timeout_falls_back(tmp_path):
    """A held lock degrades the save to the plain atomic write instead
    of blocking."""
    fcntl = pytest.importorskip("fcntl")
    path = tmp_path / "autotune.json"
    cache = AutotuneCache(path, lock_timeout_s=0.1)
    fd = os.open(str(path) + ".lock", os.O_CREAT | os.O_RDWR)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        t0 = time.monotonic()
        cache.store(_shape(5), _cfg(5))          # must not deadlock
        assert time.monotonic() - t0 < 5.0
    finally:
        os.close(fd)
    assert _shape(5).key in AutotuneCache(path).entries


def test_auto_is_the_sentinel():
    assert AUTO == ref_autotune.AUTO
    assert dse.sweep.__kwdefaults__["blk_b"] == AUTO
    for fn in (dse.sweep, dse.make_bucketed_sweep_fn, dse.search_mappings):
        kw = fn.__kwdefaults__
        assert (kw["chunk_steps"], kw["blk_b"], kw["max_buckets"]) \
            == (AUTO, AUTO, AUTO), fn.__name__
