"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``: without a CUDA device every test here skips.  On a
machine with one, run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``
(no jax needed).  Integers must be bit-identical, energy and power agree
at rtol=1e-5 (the bound the reference sets between its two backends).
The language-model kernels agree with their plain versions at the JAX
kernel tests' tolerances: attention 2e-5 in float32 and 2e-2 in
bfloat16, the intra-chunk SSD 2e-5.  The bf16 attention route on the
tensor cores is also held, element by element, to two bf16 steps of
the plain version (rtol 2^-6, atol 1e-5), as chip_smoke.py holds it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.apps import mibench  # noqa: E402
from repro_torch.core import cgra, dse, hwconfig, isa  # noqa: E402
from repro_torch.core.characterization import characterize  # noqa: E402
from repro_torch.kernels.cgra_step.ops import alu_dispatch  # noqa: E402
from repro_torch.kernels.cgra_step.ref import alu_ref  # noqa: E402
from repro_torch.kernels.cgra_sweep.ops import sweep_engine  # noqa: E402

pytestmark = pytest.mark.cuda
TOPOS = sorted(hwconfig.TOPOLOGIES)


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """AUTO knobs resolve from an empty cache of this module's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "cache.json"))
        yield


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def prof(gpu):
    return characterize(device="cpu")


def _grid(B_images=2):
    ks = mibench.all_kernels()
    return ([k.program for k in ks], [hwconfig.TOPOLOGIES[t]() for t in TOPOS],
            np.stack([k.mem_init for k in ks[:B_images]]))


def test_alu_kernel_matches_plain(gpu):
    rng = np.random.default_rng(0)
    shape = (3001, 16)
    ops = rng.integers(0, isa.N_OPS, shape).astype(np.int32)
    a, b = (rng.integers(-2**31, 2**31, shape, dtype=np.int64)
            .astype(np.int32) for _ in range(2))
    before = alu_dispatch.launches
    got = alu_dispatch(*(torch.as_tensor(x, device=gpu) for x in (ops, a, b)))
    assert alu_dispatch.launches == before + 1
    want = alu_ref(*map(torch.as_tensor, (ops, a, b)))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_alu_wrapper_rejects_mixed_devices(gpu):
    x = torch.zeros(4, 16, dtype=torch.int32)
    with pytest.raises(ValueError):
        alu_dispatch(x.to(gpu), x, x.to(gpu))


@pytest.mark.parametrize("chunk_steps,blk_b", [(64, 32), (1, 4), (7, 5),
                                               (None, 40)])
def test_sweep_kernel_matches_plain(gpu, prof, chunk_steps, blk_b):
    progs, hws, images = _grid()
    kw = dict(programs=progs, profile=prof, hw_configs=hws,
              mem_images=images, max_steps=2048, chunk_steps=chunk_steps,
              blk_b=blk_b)
    before = sweep_engine.launches
    got = dse.sweep(device=gpu, **kw)
    assert sweep_engine.launches > before
    want = dse.sweep(device="cpu", **kw)
    for f, g, w in zip(dse.SweepResult._fields, got, want):
        assert g.device.type == "cuda"
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       rtol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                          err_msg=f)


def test_run_program_and_profile_on_gpu_equal_cpu(gpu, prof):
    k = mibench.all_kernels()[3]
    fg, tg = cgra.run_program(k.program, k.mem_init, device=gpu)
    fc, tc = cgra.run_program(k.program, k.mem_init, device="cpu")
    for x, y in zip(tuple(fg) + tuple(tg), tuple(fc) + tuple(tc)):
        np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
    pg = characterize(device=gpu)
    for f in type(prof).__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(pg, f)),
                                      np.asarray(getattr(prof, f)))


def test_sweep_rejects_a_block_the_kernel_cannot_launch(gpu, prof):
    from repro_torch.kernels.cgra_sweep.ops import kernel_attributes
    too_many = kernel_attributes()["max_threads"] // 16 + 1
    progs, hws, images = _grid(1)
    with pytest.raises(ValueError, match="lanes per block"):
        dse.sweep(programs=progs, profile=prof, hw_configs=hws,
                  mem_images=images, max_steps=64, blk_b=too_many,
                  device=gpu)


def _assert_reduced_close(got, want):
    """Candidates and integers bit for bit, energy and power at 1e-5."""
    from repro_torch.analysis.pareto import REDUCED_FIELDS
    for f in REDUCED_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("max_buckets", [1, 4])
def test_reduced_sweep_on_gpu_equals_host(gpu, prof, max_buckets):
    from repro_torch.analysis import pareto
    progs, hws, images = _grid()
    kw = dict(programs=progs, profile=prof, hw_configs=hws,
              mem_images=images, max_steps=2048, max_buckets=max_buckets)
    for spec in (pareto.TopK("edp", 4),
                 pareto.ParetoFront(("latency_cc", "energy_pj"), 16)):
        before = sweep_engine.launches
        got = dse.sweep(device=gpu, reduce=spec, **kw)
        assert sweep_engine.launches > before
        _assert_reduced_close(got, dse.sweep(device="cpu", reduce=spec,
                                             **kw))
        # on the card: bit for bit the oracle over the card's own lanes
        full = dse.sweep(device=gpu, **kw)
        G, B = len(progs), full.latency_cc.shape[0]
        want = pareto.reduce_oracle(spec, [t.cpu().numpy() for t in full],
                                    np.repeat(np.arange(G), B // G),
                                    np.arange(B), G)
        for f in pareto.REDUCED_FIELDS:
            assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f


def test_search_mappings_on_gpu_equals_host(gpu, prof):
    from repro_torch.core.mapper import DAG, _program_key
    d = DAG()
    w = d.const(5)
    for j in range(6):
        t = d.alu("SADD", d.alu("SMUL", d.load(j), w), d.load(16 + j))
        d.store(32 + j, d.alu("SRA", t, d.const(2)))
    mems = np.random.default_rng(0).integers(-100, 100, (4, 128)).astype(
        np.int32)
    kw = dict(k=4, keep=2, rounds=2, max_steps=128, mem_size=128)
    before = (sweep_engine.launches, alu_dispatch.launches)
    got = dse.search_mappings([d], prof, [hwconfig.TOPOLOGIES[t]()
                                          for t in TOPOS], mems,
                              device=gpu, **kw)
    assert sweep_engine.launches > before[0]
    assert alu_dispatch.launches > before[1]    # candidate verification
    want = dse.search_mappings([d], prof, [hwconfig.TOPOLOGIES[t]()
                                           for t in TOPOS], mems,
                               device="cpu", **kw)
    assert [_program_key(p) for p in got.mappings.programs] == \
        [_program_key(p) for p in want.mappings.programs]
    assert _program_key(got.best[0]) == _program_key(want.best[0])
    for g_row, w_row in zip(got.history, want.history):
        np.testing.assert_allclose(g_row["best"], w_row["best"], rtol=1e-5)
        np.testing.assert_allclose(g_row["worst"], w_row["worst"],
                                   rtol=1e-5)
    _assert_reduced_close(got.front, want.front)


def test_runner_on_gpu_killed_and_resumed_equals_host(gpu, prof, tmp_path):
    """A runner campaign on the card stops after two units; a second
    runner on the same checkpoint directory resumes them and runs the
    rest through the kernel.  The stitched result equals the host's
    plain run bit for bit (energy included: the kernel is built with
    -fmad=false), and its one stage is the kernel."""
    from repro_torch.service import ResumableSweepRunner
    progs, hws, images = _grid()
    kw = dict(programs=progs, profile=prof, hw_configs=hws,
              mem_images=images, max_steps=2048, unit_size=7)
    first = ResumableSweepRunner(device=gpu, ckpt_dir=str(tmp_path), **kw)
    assert first.stage.name == "cuda"
    first.run_unit(0)
    first.run_unit(1)
    first.mgr.wait()
    before = sweep_engine.launches
    got, rep = ResumableSweepRunner(device=gpu, ckpt_dir=str(tmp_path),
                                    **kw).run()
    assert sweep_engine.launches > before
    assert rep.units_resumed == 2 and rep.units_run == rep.units_total - 2
    assert {r.backend for r in rep.records} == {"cuda"}
    want, _ = ResumableSweepRunner(device="cpu", **kw).run()
    for f in dse.SweepResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_sweep_on_four_shard_mesh_equals_unsharded(gpu, prof):
    """Four shards on one card (a mesh repeating the device): unreduced
    and TopK, bit for bit the unsharded sweep on the card; every shard
    launches the kernel, all on the shards' device."""
    from repro_torch.analysis import pareto
    from repro_torch.launch.mesh import make_debug_mesh
    progs, hws, images = _grid()
    mesh = make_debug_mesh(4, device=gpu)
    kw = dict(programs=progs, profile=prof, hw_configs=hws,
              mem_images=images, max_steps=2048, chunk_steps=64, blk_b=32,
              max_buckets=4)
    want = dse.sweep(device=gpu, **kw)
    sweep_engine.device_launches.clear()
    before = sweep_engine.launches
    got = dse.sweep(mesh=mesh, **kw)
    dev = str(mesh.devices.flat[0])
    assert sweep_engine.launches - before == \
        sweep_engine.device_launches[dev] > 0
    for f in dse.SweepResult._fields:
        assert getattr(got, f).device == mesh.devices.flat[0], f
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    spec = pareto.TopK("edp", 4)
    red = dse.sweep(mesh=mesh, reduce=spec, **kw)
    ref = dse.sweep(device=gpu, reduce=spec, **kw)
    for f in pareto.REDUCED_FIELDS:
        assert getattr(red, f).tobytes() == getattr(ref, f).tobytes(), f
    plan = dse.plan_grid(programs=progs, hw_configs=hws, mem_images=images,
                         device=gpu)
    grid = dse.make_grid_fn(plan, prof, max_steps=2048, mesh=mesh)
    grid(plan.img_idx, plan.hw_grid, plan.prog_idx)
    assert len(grid.shard_launches) == 4 and min(grid.shard_launches) > 0


@pytest.mark.parametrize("G,H,D", [(1, 40, 1024), (3, 5, 2)])
def test_plan_grid_on_gpu_makes_no_blocking_copy(gpu, G, H, D):
    """``plan_grid`` and a bucket's lane rows are built on the card from
    one upload that does not wait: under CUDA's sync debug mode "error"
    nothing raises.  Every per-lane row equals the CPU plan's."""
    from repro_torch.core.program import as_program_batch
    progs = [k.program for k in mibench.all_kernels()[:G]]
    hws = [hwconfig.TOPOLOGIES[TOPOS[h % len(TOPOS)]]().replace(
        n_banks=(2, 4, 8, 16)[h % 4]) for h in range(H)]
    images = np.random.default_rng(D).integers(
        0, 2**31, (D, 64)).astype(np.int32)
    on_card = torch.as_tensor(images, device=gpu)
    batch = as_program_batch(progs)
    group = list(range(G))[::-1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = dse.plan_grid(programs=progs, hw_configs=hws,
                             mem_images=on_card, device=gpu)
        _, lanes = dse._plan_lanes(batch, hws, on_card, gpu, group=group)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, want_lanes = dse._plan_lanes(batch, hws, images,
                                       torch.device("cpu"), group=group)
    assert plan.max_banks == want.max_banks
    for f in ("img_idx", "prog_idx"):
        assert getattr(plan, f).tobytes() == getattr(want, f).tobytes()
    for f in hwconfig.HwConfig.FIELDS:
        g, w = getattr(plan.hw_grid, f), getattr(want.hw_grid, f)
        assert g.device.type == "cuda" and g.dtype == w.dtype, f
        assert g.cpu().numpy().tobytes() == w.numpy().tobytes(), f
    assert len(lanes) == len(want_lanes) == 3
    for g, w in zip(lanes, want_lanes):
        assert g.dtype == w.dtype == torch.int32
        assert torch.equal(g.cpu(), w)


def test_auto_sweep_on_gpu_resolves_from_the_cache(gpu, prof, tmp_path,
                                                   monkeypatch):
    """AUTO knobs on the card come from a cache entry for the card's
    shape class (never one timed on the host) and change no result."""
    from repro_torch.core.autotune import (AutotuneCache, ShapeClass,
                                           TunedConfig)
    from repro_torch.core.program import pack_programs
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    progs, hws, images = _grid()
    shape = dict(G=len(progs), t_max=pack_programs(progs).t_max,
                 H=len(hws), D=images.shape[0])
    cache = AutotuneCache(path)
    cache.store(ShapeClass(**shape, device="cpu"),
                TunedConfig(blk_b=32, chunk_steps=None, max_buckets=1))
    cache.store(ShapeClass(**shape, device="cuda"),
                TunedConfig(blk_b=16, chunk_steps=128, max_buckets=2))
    kw = dict(programs=progs, profile=prof, hw_configs=hws,
              mem_images=images, max_steps=2048)
    fn = dse.make_bucketed_sweep_fn(device=gpu, **kw)
    assert fn.cfg.source == "cache"
    assert (fn.cfg.blk_b, fn.cfg.chunk_steps, fn.cfg.max_buckets) \
        == (16, 128, 2)
    got = dse.sweep(device=gpu, **kw)
    want = dse.sweep(device=gpu, chunk_steps=64, blk_b=32, max_buckets=4,
                     **kw)
    for f in dse.SweepResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---- the language-model kernels ---------------------------------------

def _attn_inputs(gpu, B, S, T, H, KV, hd, dtype, seed=0):
    g = torch.Generator(device=gpu).manual_seed(seed)
    return [torch.randn(B, n, h, hd, device=gpu, generator=g).to(dtype)
            for n, h in ((S, H), (T, KV), (T, KV))]


@pytest.mark.parametrize("S,T,H,KV,hd,dtype,causal,window", [
    (256, 256, 4, 4, 80, torch.bfloat16, True, None),
    (256, 256, 4, 4, 16, torch.float32, True, None),
    (256, 256, 4, 4, 128, torch.float32, True, None),
    (200, 200, 4, 2, 80, torch.float32, True, None),
    (200, 200, 4, 4, 80, torch.float32, False, None),
    (300, 300, 2, 2, 40, torch.float32, True, 70),
    (100, 300, 4, 1, 24, torch.bfloat16, False, None),
])
def test_flash_kernel_matches_plain(gpu, S, T, H, KV, hd, dtype, causal,
                                    window):
    from repro_torch.kernels.flash_attention.ops import attention
    q, k, v = _attn_inputs(gpu, 2, S, T, H, KV, hd, dtype)
    before = attention.launches
    got = attention(q, k, v, causal=causal, window=window)
    assert attention.launches == before + 1
    want = attention(q.cpu(), k.cpu(), v.cpu(), causal=causal, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window", [
    (1, 1000, 1000, 8, 8, 80, True, None),      # ragged last q- and k-tile
    (1, 512, 512, 32, 8, 80, True, None),       # GQA 32/8
    (1, 1500, 1500, 4, 4, 80, True, 512),       # window band
    (2, 300, 500, 4, 2, 80, False, None),       # no mask, T != S
    (1, 384, 384, 4, 4, 64, True, None),        # one 128-byte box of d
    (1, 257, 257, 4, 2, 128, True, 100),
    (1, 200, 200, 4, 4, 24, False, None),       # hd not a multiple of 16
    (1, 200, 200, 4, 4, 36, True, None),        # hd % 8 != 0: FMA kernel
    (1, 600, 600, 28, 4, 128, True, 256),       # qwen2-vl GQA 28/4, window
    (1, 500, 500, 15, 5, 64, True, None),       # smollm GQA 15/5
    # whisper-small: the encoder, cross-attention of a 224- and a 4-token
    # prompt against 1,500 frames (T not a multiple of the key tile, the
    # query tile nearly all padding), the decoder's causal self-attention
    (1, 1500, 1500, 12, 12, 64, False, None),
    (1, 224, 1500, 12, 12, 64, False, None),
    (1, 4, 1500, 12, 12, 64, False, None),
    (1, 224, 224, 12, 12, 64, True, None),
])
def test_flash_bf16_route_within_two_bf16_steps(gpu, B, S, T, H, KV, hd,
                                                causal, window):
    """The bf16 route (tensor cores where hd % 8 == 0) against the plain
    version on the card, TF32 off: 2e-2, and every element within two
    bf16 steps of itself."""
    from repro_torch.kernels.flash_attention.ops import (
        attention, hopper_shared_memory, last_route)
    from repro_torch.kernels.flash_attention.ref import expand_kv
    from repro_torch.kernels.flash_attention.ref import attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _attn_inputs(gpu, B, S, T, H, KV, hd, torch.bfloat16, seed=hd)
    before = attention.launches
    got = attention(q, k, v, causal=causal, window=window).float()
    assert attention.launches == before + 1
    assert last_route() == ("wgmma" if hd % 8 == 0 else "fma")
    want = attention_ref(q.transpose(1, 2), expand_kv(k, H),
                         expand_kv(v, H), causal=causal,
                         window=window).transpose(1, 2).float()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got, want, rtol=2.0 ** -6, atol=1e-5)
    assert (hopper_shared_memory(hd) > 0) == (hd % 8 == 0)


def test_flash_kernel_refuses_head_dim_over_128(gpu):
    from repro_torch.kernels.flash_attention.ops import attention
    q, k, v = _attn_inputs(gpu, 1, 64, 64, 2, 2, 136, torch.float32)
    before = attention.launches
    with pytest.raises(ValueError, match="head_dim up to 128"):
        attention(q, k, v)
    assert attention.launches == before


def _ssd_inputs(gpu, G, L, H, P, N, seed):
    g = torch.Generator(device=gpu).manual_seed(seed)
    x = torch.randn(G, L, H, P, device=gpu, generator=g)
    dt = torch.nn.functional.softplus(
        torch.randn(G, L, H, device=gpu, generator=g))
    cum = torch.cumsum(-torch.nn.functional.softplus(
        torch.randn(G, L, H, device=gpu, generator=g)), dim=1)
    Bm, Cm = (torch.randn(G, L, N, device=gpu, generator=g) for _ in "BC")
    return x, dt, cum, Bm, Cm


def _ssd_mismatch_report(ins, got, want, tag):
    """On a mismatch: launch the kernel again, run the plain version
    again, compute a float64 oracle on the host, save the inputs and all
    four outputs under the build directory, and say which side is off
    the oracle and whether the second launch repeats the first."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba2_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.mamba2_scan.ref import intra_chunk_ref
    got2 = ssd_intra_chunk(*ins).cpu()
    host = [t.cpu() for t in ins]
    want2 = ssd_intra_chunk(*host)
    exact = intra_chunk_ref(*(t.double() for t in host))

    def off(y):
        d = (y.double() - exact).abs()
        bad = d > 2e-5 + 2e-5 * exact.abs()
        return int(bad.sum()), float(d.max())

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"ssd_mismatch_{tag}.npz"
    np.savez(path, **{n: t.numpy() for n, t in zip(
        ("x", "dt", "cum", "Bm", "Cm"), host)}, kernel=got.numpy(),
        kernel_again=got2.numpy(), plain=want.numpy(),
        plain_again=want2.numpy(), oracle=exact.numpy())
    return (f"kernel off the f64 oracle (elements, max): {off(got)}, second "
            f"launch {off(got2)}, second launch equal to the first: "
            f"{torch.equal(got, got2)}; plain {off(want)}, plain again "
            f"{off(want2)}, equal: {torch.equal(want, want2)}; saved {path}")


@pytest.mark.parametrize("G,L,H,P,N", [
    (6, 64, 8, 64, 64), (3, 40, 5, 16, 16), (2, 64, 3, 50, 70),
    (1, 64, 80, 64, 64),      # G = 1
    (5, 64, 80, 64, 64),      # the smallest serving launch
    (7, 64, 13, 64, 64),      # H prime: items cross chunks mid-block
    (9, 1, 4, 64, 64),        # L = 1
    (4, 17, 6, 32, 16),       # L = 17: ragged strips and k-steps
    (3, 64, 5, 128, 128),     # P = N = 128
    (3, 48, 6, 64, 70),       # N % 4 != 0: the cp.async route
    (2, 33, 4, 7, 5),         # odd P and N, ragged L: the cp.async route
])
def test_ssd_kernel_matches_plain(gpu, G, L, H, P, N):
    from repro_torch.kernels.mamba2_scan.ops import ssd_intra_chunk
    ins = _ssd_inputs(gpu, G, L, H, P, N, G * L)
    before = ssd_intra_chunk.launches
    got = ssd_intra_chunk(*ins)
    assert ssd_intra_chunk.launches == before + 1
    want = ssd_intra_chunk(*(t.cpu() for t in ins))
    got = got.cpu()
    if not np.allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5):
        print(_ssd_mismatch_report(ins, got, want, f"{G}-{L}-{H}-{P}-{N}"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_ssd_route_follows_the_shape(gpu):
    """The serving path's shape takes the TMA route (TMA loads, f64
    products on the tensor cores); shapes whose rows TMA cannot address
    take the cp.async one (the same products)."""
    from repro_torch.kernels.mamba2_scan.ops import route
    assert route(64, 64) == "tma"
    assert route(128, 128) == "tma"
    assert route(50, 70) == "cp.async"
    assert route(64, 70) == "cp.async"


def test_ssd_last_route_follows_the_tensors(gpu):
    """A launch reports the route it took: TMA for the serving shape on
    fresh tensors, cp.async when x lies off a 16-byte boundary; both
    within 2e-5 of the plain version."""
    from repro_torch.kernels.mamba2_scan.ops import last_route, ssd_intra_chunk
    G, L, H, P, N = 2, 64, 5, 64, 64
    g = torch.Generator(device=gpu).manual_seed(3)
    x = torch.randn(G, L, H, P, device=gpu, generator=g)
    dt = torch.nn.functional.softplus(
        torch.randn(G, L, H, device=gpu, generator=g))
    cum = torch.cumsum(-torch.nn.functional.softplus(
        torch.randn(G, L, H, device=gpu, generator=g)), dim=1)
    Bm, Cm = (torch.randn(G, L, N, device=gpu, generator=g) for _ in "BC")
    want = ssd_intra_chunk(*(t.cpu() for t in (x, dt, cum, Bm, Cm)))
    got = ssd_intra_chunk(x, dt, cum, Bm, Cm)
    assert last_route() == "tma"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    shifted = torch.empty(x.numel() + 1, device=gpu)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    got = ssd_intra_chunk(shifted, dt, cum, Bm, Cm)
    assert last_route() == "cp.async"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_smoke_zamba2_on_gpu_matches_cpu(gpu):
    """The smoke model's prefill and three teacher-forced decode steps,
    card against host with the same weights; f32 sums in another order:
    1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import make_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("zamba2-2.7b")
    mg, mc = make_model(cfg, device=gpu), make_model(cfg, device="cpu")
    pg = mg.init(0)
    pc = mc.init(0)
    pc.load_state_dict({k: v.cpu() for k, v in pg.state_dict().items()})
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                             (1, 100)))
    lg, cg = mg.prefill(pg, {"tokens": toks.to(gpu)}, context=128)
    lc, cc = mc.prefill(pc, {"tokens": toks}, context=128)
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4,
                               atol=1e-4)
    for t in range(3):
        nxt = lc[:, -1].argmax(-1)[:, None]
        lg, cg = mg.decode(pg, nxt.to(gpu), cg, 100 + t)
        lc, cc = mc.decode(pc, nxt, cc, 100 + t)
        np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", [
    "llama3.2-1b", "granite-moe-1b-a400m", "qwen2-vl-7b", "olmo-1b",
    "smollm-360m", "starcoder2-15b", "mixtral-8x22b"])
def test_smoke_transformer_on_gpu_matches_cpu(gpu, arch):
    """Each transformer-family smoke config: a 20-token prefill (past the
    SWA configs' window of 8; qwen2-vl with patch embeds) and three
    teacher-forced decode steps, card against host with the same
    weights, the MoE's chosen experts first; f32 sums in another order:
    1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import make_model, moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    mg, mc = make_model(cfg, device=gpu), make_model(cfg, device="cpu")
    pg = mg.init(0)
    pc = mc.init(0)
    pc.load_state_dict({k: v.cpu() for k, v in pg.state_dict().items()})
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (1, 20)))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(rng.standard_normal(
            (1, cfg.n_patches, cfg.d_model)).astype(np.float32))
    seen = {}

    def route(side, i):
        def hook(mod, args, out):
            probs = moe.router_probs(mod, args[0])
            seen.setdefault(side, []).append(
                (i, probs.cpu(), moe.topk_experts(probs, cfg.top_k).cpu()))
        return hook
    for side, params in (("card", pg), ("host", pc)):
        for i, layer in enumerate(params.layers):
            if cfg.family == "moe":
                layer.mlp.register_forward_hook(route(side, i))
    lg, cg = mg.prefill(pg, {k: v.to(gpu) for k, v in batch.items()},
                        context=64)
    lc, cc = mc.prefill(pc, batch, context=64)
    outs = [(lg, lc)]
    for t in range(3):
        nxt = lc[:, -1].argmax(-1)[:, None]
        lg, cg = mg.decode(pg, nxt.to(gpu), cg, 20 + t)
        lc, cc = mc.decode(pc, nxt, cc, 20 + t)
        outs.append((lg, lc))
    for (i, _, a), (_, probs, b) in zip(seen.get("card", []),
                                        seen.get("host", [])):
        if not torch.equal(a, b):
            row, tok = (a != b).any(-1).nonzero()[0].tolist()
            top = probs[row, tok].sort(descending=True).values
            pytest.fail(f"{arch}: MoE routing differs at layer {i}, token "
                        f"{tok}: card {a[row, tok].tolist()}, host "
                        f"{b[row, tok].tolist()}; gap between the k-th and "
                        f"(k+1)-th probability "
                        f"{float(top[cfg.top_k - 1] - top[cfg.top_k]):.3g}")
    assert len(seen.get("card", [])) == (4 * cfg.n_layers
                                         if cfg.family == "moe" else 0)
    for g, c in outs:
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-small", "xlstm-350m"])
def test_smoke_encdec_and_xlstm_on_gpu_match_cpu(gpu, arch):
    """The whisper and xLSTM smoke configs: a 20-token prefill (whisper's
    with seeded frames) and three teacher-forced decode steps, card
    against host with the same weights; f32 sums in another order: 1e-4.
    Whisper's prefill launches the flash kernel once per encoder layer and
    twice per decoder layer; the xLSTM's launches it not at all."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.models import make_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    mg, mc = make_model(cfg, device=gpu), make_model(cfg, device="cpu")
    pg = mg.init(0)
    pc = mc.init(0)
    pc.load_state_dict({k: v.cpu() for k, v in pg.state_dict().items()})
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (1, 20)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (1, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    before = attention.launches
    lg, cg = mg.prefill(pg, {k: v.to(gpu) for k, v in batch.items()},
                        context=64)
    assert attention.launches - before == (
        cfg.n_enc_layers + 2 * cfg.n_layers if cfg.family == "encdec"
        else 0)
    lc, cc = mc.prefill(pc, batch, context=64)
    outs = [(lg, lc)]
    for t in range(3):
        nxt = lc[:, -1].argmax(-1)[:, None]
        lg, cg = mg.decode(pg, nxt.to(gpu), cg, 20 + t)
        lc, cc = mc.decode(pc, nxt, cc, 20 + t)
        outs.append((lg, lc))
    for g, c in outs:
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("seed", range(6))
def test_lm_kernels_repeat_bit_for_bit_and_match_card_plain(gpu, seed):
    """Each kernel gives the same bits on a second launch with the same
    inputs, and agrees with its plain version run on the card (TF32
    off) at the tolerances above."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.mamba2_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.mamba2_scan.ref import intra_chunk_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=gpu).manual_seed(100 + seed)
    G, L, H, P, N = (6, 64, 8, 64, 64) if seed % 2 else (4, 37, 5, 32, 16)
    x = torch.randn(G, L, H, P, device=gpu, generator=g)
    dt = torch.nn.functional.softplus(
        torch.randn(G, L, H, device=gpu, generator=g))
    cum = torch.cumsum(-torch.nn.functional.softplus(
        torch.randn(G, L, H, device=gpu, generator=g)), dim=1)
    Bm, Cm = (torch.randn(G, L, N, device=gpu, generator=g) for _ in "BC")
    y1 = ssd_intra_chunk(x, dt, cum, Bm, Cm)
    y2 = ssd_intra_chunk(x, dt, cum, Bm, Cm)
    assert torch.equal(y1, y2)
    torch.testing.assert_close(y1, intra_chunk_ref(x, dt, cum, Bm, Cm),
                               rtol=2e-5, atol=2e-5)
    q, k, v = _attn_inputs(gpu, 1, 300, 300, 4, 2, 80, torch.bfloat16,
                           seed)
    o1 = attention(q, k, v)
    assert torch.equal(o1, attention(q, k, v))


# ---------------------------------------------------------------------------
# The backward kernels, the forward's row log-sum-exp, and the probes for
# unwritten outputs (NaN-filled) and stale shared memory (poisoned)
# ---------------------------------------------------------------------------

FLASH_BWD_CASES = [  # (B, S, T, H, KV, hd, dtype, causal, window)
    (1, 256, 256, 4, 4, 80, torch.bfloat16, True, None),
    (2, 130, 130, 4, 2, 80, torch.bfloat16, True, None),
    (1, 200, 200, 4, 4, 16, torch.float32, True, None),
    (1, 150, 150, 2, 2, 128, torch.float32, True, None),
    (1, 100, 100, 4, 4, 80, torch.float32, False, None),
    (1, 300, 300, 4, 4, 80, torch.float32, True, 64),
    (1, 190, 190, 8, 2, 80, torch.float32, True, None),
    (1, 70, 200, 4, 2, 80, torch.float32, False, None),    # S < T
    (1, 64, 150, 4, 4, 80, torch.bfloat16, False, 40),     # S < T, window
    (1, 1000, 1000, 4, 4, 80, torch.bfloat16, True, None),  # ragged
    (1, 256, 256, 8, 2, 80, torch.bfloat16, True, None),    # GQA
    # GQA over 4 heads x 2048 queries: dK and dV sum 1,024 tensor-core
    # k-steps a key, where the tensor cores' own f32 sums drift
    (1, 2048, 2048, 8, 2, 80, torch.bfloat16, True, None),
    (1, 100, 100, 2, 2, 20, torch.bfloat16, True, None),    # bf16 FMA route
    # the families' training shapes, cut to the card tests' size: hd 64
    # with GQA 4 over 2 x 4096 queries (llama: the dK/dV chain of 4 heads
    # x 4096 queries), hd 128 with GQA 7 (qwen2-vl), MHA and a window,
    # whisper's non-causal encoder, its cross-attention of 448 queries
    # against 1,500 keys (a ragged last key tile) and its causal decoder
    (2, 4096, 4096, 8, 2, 64, torch.bfloat16, True, None),
    (1, 512, 512, 14, 2, 128, torch.bfloat16, True, None),
    (1, 384, 384, 4, 4, 128, torch.bfloat16, True, None),
    (1, 1024, 1024, 8, 2, 128, torch.bfloat16, True, 512),
    (2, 1500, 1500, 2, 2, 64, torch.bfloat16, False, None),
    (2, 448, 1500, 2, 2, 64, torch.bfloat16, False, None),
    (2, 448, 448, 2, 2, 64, torch.bfloat16, True, None),
]


def _bwd_route(dtype, hd):
    """The backward's route for fresh (aligned) tensors: the tensor cores
    for bf16 with head_dim a multiple of 8, the FMA kernels otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and hd % 8 == 0 else "fma"


def _flash_case(gpu, B, S, T, H, KV, hd, dtype, seed=0):
    q, k, v = _attn_inputs(gpu, B, S, T, H, KV, hd, dtype, seed)
    g = torch.Generator(device=gpu).manual_seed(seed + 7)
    dout = torch.randn(B, S, H, hd, device=gpu, generator=g).to(dtype)
    return q, k, v, dout


def _grad_close(got, want, dtype):
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:   # two bf16 steps of each element
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -6, atol=1e-5)


@pytest.mark.parametrize("B,S,T,H,KV,hd,dtype,causal,window",
                         FLASH_BWD_CASES)
def test_flash_lse_matches_plain_logsumexp(gpu, B, S, T, H, KV, hd, dtype,
                                           causal, window):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import expand_kv
    q, k, v, _ = _flash_case(gpu, B, S, T, H, KV, hd, dtype)
    out, lse, out32 = ops._launch(q, k, v, causal, window, lse=True)
    plain, _, _ = ops._launch(q, k, v, causal, window)
    assert torch.equal(out, plain)      # serving's output is unchanged
    # the f32 output is kept where the tensor-core backward reads it, and
    # rounds to the output
    assert (out32 is not None) == (_bwd_route(dtype, hd) == "wgmma")
    if out32 is not None:
        assert torch.equal(out32.to(dtype), out)
    logits = torch.einsum("bhsd,bhtd->bhst", q.transpose(1, 2).double(),
                          expand_kv(k, H).double()) / hd ** 0.5
    i = torch.arange(S, device=gpu)[:, None]
    j = torch.arange(T, device=gpu)[None]
    band = (j <= i) if causal else torch.ones_like(i * j, dtype=torch.bool)
    if window:
        band &= (i - j) < window
    want = torch.logsumexp(logits.masked_fill(~band, float("-inf")), -1)
    torch.testing.assert_close(lse.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,T,H,KV,hd,dtype,causal,window",
                         FLASH_BWD_CASES)
def test_flash_bwd_kernels_match_plain(gpu, B, S, T, H, KV, hd, dtype,
                                       causal, window):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout = _flash_case(gpu, B, S, T, H, KV, hd, dtype, seed=S)
    _, lse, out32 = ops._launch(q, k, v, causal, window, lse=True)
    before = ops.attention_bwd.launches
    got = ops.attention_bwd(q, k, v, dout, lse, causal=causal, window=window,
                            out32=out32)
    assert ops.attention_bwd.launches == before + 2
    assert ops.last_bwd_route() == _bwd_route(dtype, hd)
    again = ops.attention_bwd(q, k, v, dout, lse, causal=causal,
                              window=window, out32=out32)
    want = attention_bwd_ref(q, k, v, dout, causal=causal, window=window)
    for a, b, w, t in zip(got, again, want, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert torch.equal(a, b)         # no atomics: the same bits
        _grad_close(a, w, dtype)


@pytest.mark.parametrize("G,L,H,P,N", [
    (128, 64, 80, 64, 64), (6, 64, 8, 64, 64), (3, 40, 5, 16, 16),
    (9, 1, 4, 64, 64), (4, 17, 6, 32, 16), (3, 64, 5, 128, 128),
    (2, 33, 4, 7, 5)])
def test_ssd_bwd_kernels_match_plain(gpu, G, L, H, P, N):
    from repro_torch.kernels.mamba2_scan import ops
    from repro_torch.kernels.mamba2_scan.ref import intra_chunk_bwd_ref
    ins = _ssd_inputs(gpu, G, L, H, P, N, G + L)
    dy = torch.randn(G, L, H, P, device=gpu,
                     generator=torch.Generator(device=gpu).manual_seed(9))
    before = ops.ssd_intra_chunk_bwd.launches
    got = ops.ssd_intra_chunk_bwd(*ins, dy)
    assert ops.ssd_intra_chunk_bwd.launches == before + 1
    again = ops.ssd_intra_chunk_bwd(*ins, dy)
    want = intra_chunk_bwd_ref(*ins, dy)
    for name, a, b, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, again,
                             want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4, msg=name)


def _nan_like(t):
    return torch.full_like(t, float("nan"))


@pytest.mark.parametrize("poison", [False, True])
def test_lm_kernels_write_every_output_and_read_no_stale_shared_memory(
        gpu, poison):
    """Every output filled with NaN before the launch comes back finite
    and equal to a launch into fresh memory; with ``poison`` every SM's
    shared memory holds NaN before each launch, so a read of a word the
    kernel never wrote shows too.  All four LM kernels, both flash
    routes forward and backward."""
    from repro_torch.kernels.common import poison_shared_memory
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.mamba2_scan import ops as so

    def before_launch():
        if poison:
            assert poison_shared_memory(gpu) > 0

    for G, L, H, P, N in [(6, 64, 8, 64, 64), (5, 64, 80, 64, 64),
                          (4, 17, 6, 32, 16), (2, 33, 4, 7, 5)]:
        ins = _ssd_inputs(gpu, G, L, H, P, N, 11 * G + L)
        fresh = so._launch(*ins)
        before_launch()
        y = so._launch(*ins, out=_nan_like(ins[0]))
        assert torch.equal(y, fresh), (G, L, H, P, N)
        dy = torch.randn_like(ins[0])
        fresh = so._launch_bwd(*ins, dy)
        before_launch()
        got = so._launch_bwd(*ins, dy, grads=[_nan_like(t) for t in ins])
        for a, b in zip(got, fresh):
            assert torch.equal(a, b), (G, L, H, P, N)
    for B, S, T, H, KV, hd, dtype, causal, window in FLASH_BWD_CASES:
        q, k, v, dout = _flash_case(gpu, B, S, T, H, KV, hd, dtype, seed=3)
        fresh, lse, o32 = fo._launch(q, k, v, causal, window, lse=True)
        before_launch()
        out, rows, rows32 = fo._launch(
            q, k, v, causal, window, lse=True, out=_nan_like(q),
            rows=_nan_like(lse),
            out32=None if o32 is None else _nan_like(o32))
        assert torch.equal(out, fresh) and torch.equal(rows, lse)
        assert (o32 is None and rows32 is None) or torch.equal(rows32, o32)
        fresh = fo._launch_bwd(q, k, v, dout, lse, causal, window, out32=o32)
        assert fo.last_bwd_route() == _bwd_route(dtype, hd)
        before_launch()
        got = fo._launch_bwd(q, k, v, dout, lse, causal, window, out32=o32,
                             grads=[_nan_like(t) for t in (q, k, v)])
        for a, b in zip(got, fresh):
            assert torch.equal(a, b), (B, S, H, KV, hd, dtype)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_smoke_train_step_on_gpu_matches_cpu(gpu, remat):
    """Two AdamW steps of the smoke model through the kernels and their
    backward kernels, card against host with the same weights: loss,
    grad_norm and every parameter at 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import make_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_step import TrainState, param_tree
    from repro_torch.train.optim import adamw_init
    from repro_torch.kernels.flash_attention.ops import attention_bwd
    from repro_torch.kernels.mamba2_scan.ops import ssd_intra_chunk_bwd
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("zamba2-2.7b").replace(remat=remat)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant",
                      eps=1e-3)
    states = []
    for dev in (gpu, torch.device("cpu")):
        m = make_model(cfg, device=dev)
        p = m.init(0).requires_grad_(True)
        states.append((m, TrainState(p, adamw_init(param_tree(p)), None)))
    states[1][1].params.load_state_dict(
        {k: t.cpu() for k, t in states[0][1].params.state_dict().items()})
    rng = np.random.default_rng(5)
    f0, s0 = attention_bwd.launches, ssd_intra_chunk_bwd.launches
    for i in range(2):
        toks = rng.integers(0, cfg.vocab, (2, 101))
        outs = []
        for j, (m, st) in enumerate(states):
            batch = {"tokens": torch.as_tensor(toks[:, :-1], device=m.device),
                     "labels": torch.as_tensor(toks[:, 1:], device=m.device)}
            st, met = make_train_step(m, opt)(st, batch)
            states[j] = (m, st)
            outs.append({k: float(v) for k, v in met.items()})
        for k in ("loss", "grad_norm"):
            assert outs[0][k] == pytest.approx(outs[1][k], rel=1e-4, abs=1e-4)
    assert attention_bwd.launches - f0 == 2 * 2 * 2     # 2 steps x 2 apps
    assert ssd_intra_chunk_bwd.launches - s0 == 2 * 4 * 1
    for (n, a), b in zip(states[0][1].params.named_parameters(),
                         states[1][1].params.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4,
                                   atol=1e-4, msg=n)


@pytest.mark.parametrize("arch", [
    "llama3.2-1b", "granite-moe-1b-a400m", "qwen2-vl-7b", "olmo-1b",
    "smollm-360m", "starcoder2-15b", "mixtral-8x22b", "whisper-small",
    "xlstm-350m"])
def test_smoke_family_train_steps_on_gpu_match_cpu(gpu, arch):
    """Two AdamW steps of each non-hybrid smoke config under remat "dots"
    (the flash forward twice a layer, its backward kernels once), card
    against host with the same weights and the trainer's batches (frames,
    patch embeds and positions included): the experts every MoE router
    call chose, then loss, grad_norm and every parameter at 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_stream
    from repro_torch.kernels.flash_attention.ops import attention_bwd
    from repro_torch.models import make_model, moe
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.train_step import TrainState, param_tree
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch).replace(remat="dots")
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant",
                      eps=1e-3)
    states = []
    for dev in (gpu, torch.device("cpu")):
        m = make_model(cfg, device=dev)
        p = m.init(0).requires_grad_(True)
        states.append((m, TrainState(p, adamw_init(param_tree(p)), None)))
    states[1][1].params.load_state_dict(
        {k: t.cpu() for k, t in states[0][1].params.state_dict().items()})
    routes = {}
    router_probs = moe.router_probs

    def recorded(p, x):
        probs = router_probs(p, x)
        routes.setdefault(x.device.type, []).append(
            moe.topk_experts(probs, p.cfg.top_k).cpu())
        return probs

    stream = make_stream(cfg, 32, 2, seed=3)
    f0 = attention_bwd.launches
    moe.router_probs = recorded
    try:
        for i in range(2):
            outs = []
            for j, (m, st) in enumerate(states):
                batch = {k: torch.as_tensor(v, device=m.device)
                         for k, v in stream.batch_at(i).items()}
                st, met = make_train_step(m, opt)(st, batch)
                states[j] = (m, st)
                outs.append({k: float(v) for k, v in met.items()})
            for k in ("loss", "grad_norm"):
                assert outs[0][k] == pytest.approx(outs[1][k], rel=1e-4,
                                                   abs=1e-4)
    finally:
        moe.router_probs = router_probs
    assert len(routes.get("cuda", [])) == len(routes.get("cpu", []))
    for a, b in zip(routes.get("cuda", []), routes.get("cpu", [])):
        assert torch.equal(a, b)
    calls = (cfg.n_enc_layers + 2 * cfg.n_layers if cfg.family == "encdec"
             else 0 if cfg.family == "ssm" else cfg.n_layers)
    assert attention_bwd.launches - f0 == 2 * calls * 2   # 2 steps
    for (n, a), b in zip(states[0][1].params.named_parameters(),
                         states[1][1].params.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4,
                                   atol=1e-4, msg=n)


def test_pipeline_schedule_on_gpu_is_gpipe(gpu):
    """The host's tick loop drives the card's stage streams: tick t runs
    microbatch t - s on stage s, over M + S - 1 ticks, and the result
    comes back on the first stage's device."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    calls = []

    def stage_fn(s, h):
        calls.append((s, int(h[0, 0])))
        return h + 0

    mesh = make_debug_mesh(3, ("stage",), device="cuda:0")
    x = torch.arange(5.0)[:, None, None].expand(5, 1, 2).clone()
    y = pipeline_apply(stage_fn, mesh, n_microbatches=5)([0, 1, 2], x)
    assert y.device.type == "cuda" and torch.equal(y.cpu(), x)
    assert calls == [(s, t - s) for t in range(5 + 3 - 1) for s in range(3)
                     if 0 <= t - s < 5]


def test_pipelined_llama_cut_on_gpu_matches_host(gpu):
    """llama3.2-1b at full width cut to 2 layers, f32, TF32 off: 2 stages
    of one decoder layer on cuda:0 (each on a stream of its own), 4
    microbatches of (1, 256) tokens' embeddings, against the same
    pipeline on the host at 1e-3 and against the card's own trunk run
    microbatch by microbatch bit for bit; one flash launch a layer a
    microbatch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import make_model
    from repro_torch.parallel.pipeline import pipeline_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3.2-1b").replace(n_layers=2, dtype="float32")
    pg = make_model(cfg, device=gpu).init(0)
    pc = make_model(cfg, device="cpu").init(1)
    pc.load_state_dict({k: v.cpu() for k, v in pg.state_dict().items()})
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 256)))
    outs = {}
    for side, params, mesh in (
            ("card", pg, make_debug_mesh(2, ("stage",), device="cuda:0")),
            ("host", pc, make_debug_mesh(2, ("stage",), device="cpu"))):
        dev = mesh.flat()[0]
        pos = torch.arange(256, dtype=torch.int32, device=dev)[None]

        def stage_fn(layer, h, pos=pos):
            return layer(h, pos)[0]

        with torch.no_grad():
            x = L.embed_tokens(params.embed, cfg, tokens.to(dev))[:, None]
            fo.attention.launches = 0
            y = pipeline_apply(stage_fn, mesh, n_microbatches=4)(
                list(params.layers), x)
            launches = fo.attention.launches
            seq = torch.stack([stage_fn(params.layers[1],
                                        stage_fn(params.layers[0], x[m]))
                               for m in range(4)])
        outs[side] = (y, seq, launches)
    y, seq, launches = outs["card"]
    assert launches == 2 * 4
    assert torch.equal(y, seq)
    np.testing.assert_allclose(y.cpu().numpy(), outs["host"][0].numpy(),
                               rtol=1e-3, atol=1e-3)
    assert torch.equal(outs["host"][0], outs["host"][1])
