"""Plain version of the fused sweep engine against the reference's
Pallas engine (interpret mode, blk_b=4), on the reference's own random
straight-line programs and branchy loop kernel over seven hardware
configs.  Integers bit-identical, energy and power at rtol=1e-5 (the
bound tests/test_sweep_backends.py sets between the reference's own two
backends).  Chunking and a ragged lane batch must not change a result.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import dse as ref_dse  # noqa: E402
from repro.core.hwconfig import stack_configs as ref_stack  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.kernels.cgra_sweep.ops import sweep_engine  # noqa: E402
from tests.test_sweep_backends import (MAX_STEPS, MEM, _hw_batch,  # noqa
                                       _loop_program, _random_program)

INT_FIELDS = ("latency_cc", "checksum", "steps_executed")


def _reference(program, mem, hws, profile):
    fn = ref_dse.make_sweep_fn(program, profile, mem_size=MEM,
                               max_steps=MAX_STEPS, backend="pallas",
                               interpret=True, blk_b=4)
    mems = np.broadcast_to(mem, (len(hws), mem.size)).copy()
    return jax.tree.map(np.asarray, fn(mems, ref_stack(hws)))


def _port(program, mem, hws, profile, **kw):
    fn = dse.make_sweep_fn(
        convert.program_from_numpy(dataclasses.asdict(program)),
        convert.profile_from_numpy(dataclasses.asdict(profile)),
        mem_size=MEM, max_steps=MAX_STEPS, device="cpu", **kw)
    hw = convert.hwconfig_from_numpy(ref_stack(hws).as_dict())
    mems = np.broadcast_to(mem, (len(hws), mem.size)).copy()
    return [t.numpy() for t in fn(mems, hw)]


def _assert_close(got, want):
    for f, g, w in zip(dse.SweepResult._fields, got, want):
        if f in INT_FIELDS:
            assert g.dtype == np.int32, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g.dtype == np.float32, f
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sweep_ref_matches_pallas_random_programs(seed, profile):
    program, mem = _random_program(seed)
    hws = _hw_batch()
    _assert_close(_port(program, mem, hws, profile),
                  _reference(program, mem, hws, profile))


@pytest.mark.parametrize("chunk_steps", [1, 7, 64, None])
def test_sweep_ref_matches_pallas_loop_kernel(chunk_steps, profile):
    program, mem = _loop_program()
    hws = _hw_batch()
    _assert_close(_port(program, mem, hws, profile, chunk_steps=chunk_steps),
                  _reference(program, mem, hws, profile))


@pytest.mark.parametrize("blk_b", [4, 5, 32])
def test_ragged_lane_batch_is_invisible(blk_b, profile):
    """7 lanes never fill the last block of 4 or 5 lanes (or one of 32)."""
    program, mem = _random_program(5)
    hws = _hw_batch()
    assert len(hws) % 4 and len(hws) % 5
    _assert_close(_port(program, mem, hws, profile, blk_b=blk_b),
                  _reference(program, mem, hws, profile))


def test_cpu_sweep_launches_no_kernel(profile):
    program, mem = _loop_program()
    before = sweep_engine.launches
    _port(program, mem, _hw_batch(), profile)
    assert sweep_engine.launches == before


def test_sweep_engine_checks_its_operands(profile):
    from repro_torch.core.hwconfig import baseline, stack_configs
    from repro_torch.core.program import pack_programs
    from repro_torch.kernels.cgra_sweep.ref import init_lanes
    program, mem = _loop_program()
    batch = pack_programs([convert.program_from_numpy(
        dataclasses.asdict(program))])
    prof = convert.profile_from_numpy(dataclasses.asdict(profile))
    tables = dse.sweep_tables(batch, prof, torch.device("cpu"))
    hws = convert.hwconfig_from_numpy(ref_stack(_hw_batch()).as_dict())
    B = hws.n_banks.shape[0]

    def run(tables=tables, hw=hws, gidx=torch.zeros(B, dtype=torch.int32),
            mem=torch.as_tensor(np.tile(mem, (B, 1)))):
        sweep_engine(tables, hw, gidx, init_lanes(mem, 16), rows=4, cols=4,
                     max_steps=MAX_STEPS)

    run()
    with pytest.raises(ValueError, match=r"operand hw\."):
        run(hw=stack_configs([baseline()] * (B + 1)))
    with pytest.raises(ValueError, match="p_dec"):
        run(tables=tables._replace(p_dec=tables.p_dec[:-1]))
    with pytest.raises(ValueError, match="gidx"):
        run(gidx=torch.zeros(B + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="mem"):
        run(mem=torch.zeros(B, MEM, dtype=torch.int64))
