"""The port's simulator, contention model and characterization against
the JAX reference, on the CPU.

run_program's final state and every StepRecord field must be
bit-identical to repro.core.cgra.run_program's (including the frozen
rows a full max_steps run records after EXIT); each KernelCase.check
must pass; characterize() must equal the reference profile field for
field; the vectorized contention model must equal the reference's serial
scan.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.apps import mibench as ref_mibench  # noqa: E402
from repro.core import cgra as ref_cgra, hwconfig as ref_hw  # noqa: E402
from repro.core import memory as ref_memory  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import conv, mibench  # noqa: E402
from repro_torch.core import cgra, hwconfig, memory  # noqa: E402
from repro_torch.core.characterization import (Profile,  # noqa: E402
                                               characterize, default_profile)

TOPOS = sorted(ref_hw.TOPOLOGIES)


def _assert_run_equal(ref_run, port_run):
    (rf, rt), (pf, pt) = ref_run, port_run
    for f in ref_cgra.SimState._fields:
        np.testing.assert_array_equal(getattr(pf, f).numpy(),
                                      np.asarray(getattr(rf, f)), err_msg=f)
    for f in ref_cgra.StepRecord._fields:
        got, want = getattr(pt, f).numpy(), np.asarray(getattr(rt, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("idx", range(5))
def test_run_program_matches_reference_mibench(idx, topo):
    rk, pk = ref_mibench.all_kernels()[idx], mibench.all_kernels()[idx]
    ref_run = rk.run(ref_hw.TOPOLOGIES[topo]())
    port_run = pk.run(hwconfig.TOPOLOGIES[topo](), device="cpu")
    _assert_run_equal(ref_run, port_run)
    assert pk.check(port_run[0].mem.numpy())


@pytest.mark.parametrize("idx", range(4))
def test_run_program_matches_reference_conv(idx, conv_runs):
    ref_case, rf, rt = conv_runs[idx]
    pk = conv.all_mappings()[idx]
    assert pk.name == ref_case.name
    port_run = pk.run(device="cpu")
    _assert_run_equal((rf, rt), port_run)
    assert pk.check(port_run[0].mem.numpy())


def test_run_program_stops_at_max_steps_like_reference():
    """A budget shorter than the kernel: the partial state and trace."""
    rk, pk = ref_mibench.all_kernels()[1], mibench.all_kernels()[1]
    ref_run = ref_cgra.run_program(rk.program, rk.mem_init, max_steps=100)
    port_run = cgra.run_program(pk.program, pk.mem_init, max_steps=100,
                                device="cpu")
    assert not bool(port_run[0].done)
    _assert_run_equal(ref_run, port_run)


def test_characterize_equals_reference_profile(profile):
    got = characterize(device="cpu")
    want = convert.profile_from_numpy(dataclasses.asdict(profile))
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert type(g) is type(w), f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_default_profile_caches_its_own_file(profile, tmp_path):
    path = tmp_path / "sub" / "profile.npz"
    first = default_profile(path, device="cpu")
    assert path.exists()
    again = default_profile(path, device="cpu")     # loaded, not refitted
    want = convert.profile_from_numpy(dataclasses.asdict(profile))
    for got in (first, again, Profile.load(path)):
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name))


def _ref_completion(is_mem, addr, hw):
    """The reference's serial scan, vmapped over rows (and hw fields)."""
    fn = jax.vmap(lambda m, a, h: ref_memory.mem_completion_times(
        m, a, h, 4096, 4), in_axes=(0, 0, 0 if np.ndim(hw.n_banks) else None))
    return np.asarray(jax.jit(fn)(is_mem, addr, hw))


def _rand_requests(rng, n, P=16, mem=4096):
    is_mem = rng.random((n, P)) < rng.random((n, 1))
    # few distinct addresses, so banks and DMAs collide often
    addr = rng.integers(0, mem, (n, 1)) + rng.integers(0, 40, (n, P))
    return is_mem, (addr % mem).astype(np.int32)


@pytest.mark.parametrize("cfg", [
    dict(), dict(bus=1), dict(bus=1, interleaved=1, n_banks=8),
    dict(bus=1, interleaved=1, n_banks=16, dma_per_pe=1, t_mem=3),
    dict(bus=1, interleaved=0, n_banks=3), dict(bus=1, n_banks=1),
    dict(dma_per_pe=1, t_mem=5)])
def test_mem_completion_matches_reference_scan(cfg):
    rng = np.random.default_rng(len(str(cfg)))
    is_mem, addr = _rand_requests(rng, 300)
    rhw = ref_hw.HwConfig(**cfg)
    phw = hwconfig.HwConfig(**cfg)
    got = memory.mem_completion_times(torch.as_tensor(is_mem),
                                      torch.as_tensor(addr), phw, 4096, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  _ref_completion(is_mem, addr, rhw))


def test_mem_completion_per_lane_configs():
    """(B,) hardware fields: each lane under its own configuration."""
    rng = np.random.default_rng(7)
    is_mem, addr = _rand_requests(rng, 40)
    cfgs = [hwconfig.TOPOLOGIES[t]() for t in TOPOS] * 8
    got = memory.mem_completion_times(torch.as_tensor(is_mem),
                                      torch.as_tensor(addr),
                                      hwconfig.stack_configs(cfgs), 4096, 4)
    ref_cfgs = ref_hw.stack_configs([ref_hw.TOPOLOGIES[t]()
                                     for t in TOPOS] * 8)
    np.testing.assert_array_equal(got.numpy(),
                                  _ref_completion(is_mem, addr, ref_cfgs))


def test_store_arbitration_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(50):
        is_store = rng.random(16) < 0.6
        addr = rng.integers(0, 5, 16).astype(np.int32)
        val = rng.integers(-100, 100, 16).astype(np.int32)
        mem = rng.integers(-9, 9, 8).astype(np.int32)
        landed = np.asarray(ref_cgra._dedup_stores(is_store, addr))
        want = mem.copy()
        want[addr[landed]] = val[landed]
        got = torch.as_tensor(mem.copy())
        cgra.apply_stores(got, torch.as_tensor(addr),
                          torch.as_tensor(is_store), torch.as_tensor(val),
                          got[torch.as_tensor(addr).long()])
        np.testing.assert_array_equal(got.numpy(), want)


def test_bank_bound_raises():
    with pytest.raises(AssertionError, match="HARD_MAX_BANKS"):
        memory.scoreboard_bound(memory.HARD_MAX_BANKS + 1)
    with pytest.raises(AssertionError, match="max_banks=16"):
        memory.validate_bank_bound(torch.tensor([4, 32]), 16)
    assert memory.scoreboard_bound(17) == 32
    k = mibench.all_kernels()[4]
    with pytest.raises(AssertionError):
        cgra.run_program(k.program, k.mem_init,
                         hwconfig.HwConfig(n_banks=512), device="cpu")
