"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``: without a CUDA device every test here skips.  On a
machine with one, run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``
(no jax needed).  Integers must be bit-identical, energy and power agree
at rtol=1e-5 (the bound the reference sets between its two backends).
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
