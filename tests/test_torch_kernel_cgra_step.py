"""Plain version of the ALU-dispatch kernel against the reference's
Pallas kernel (interpret mode), bit for bit, on seeded planes with the
int32 extremes, negative shifts and every opcode; and the wrapper's
CPU path and checks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.cgra_step.ops import batched_alu  # noqa: E402
from repro_torch.core import isa  # noqa: E402
from repro_torch.kernels.cgra_step.ops import alu_dispatch  # noqa: E402
from repro_torch.kernels.cgra_step.ref import alu_ref  # noqa: E402

I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _planes(seed, B=512, P=16):
    rng = np.random.default_rng(seed)
    ops = rng.integers(0, isa.N_OPS, (B, P)).astype(np.int32)
    ops[0] = np.arange(P) % isa.N_OPS            # every opcode appears
    ops[1] = (np.arange(P) + P) % isa.N_OPS
    a = rng.integers(I32_MIN, I32_MAX, (B, P), dtype=np.int64)
    b = rng.integers(I32_MIN, I32_MAX, (B, P), dtype=np.int64)
    edge = np.array([I32_MIN, I32_MAX, -1, 0, 1, 31, 32, -31, -33])
    a[2:20] = rng.choice(edge, (18, P))
    b[2:20] = rng.choice(edge, (18, P))
    b[20:40] = rng.integers(-64, 64, (20, P))    # small and negative shifts
    return ops, a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alu_ref_matches_pallas_kernel(seed):
    ops, a, b = _planes(seed)
    want = np.asarray(batched_alu(jnp.asarray(ops), jnp.asarray(a),
                                  jnp.asarray(b), impl="pallas_interpret"))
    got = alu_ref(*map(torch.as_tensor, (ops, a, b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_alu_ref_every_op_at_the_extremes():
    vals = np.array([I32_MIN, I32_MAX, -7, 0, 5], np.int32)
    a, b = (x.reshape(-1) for x in np.meshgrid(vals, vals))
    for op in range(isa.N_OPS):
        ops = np.full_like(a, op)
        want = np.asarray(batched_alu(jnp.asarray(ops[None]),
                                      jnp.asarray(a[None]),
                                      jnp.asarray(b[None]), impl="ref"))[0]
        got = alu_ref(*map(torch.as_tensor, (ops, a, b)))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=isa.OPCODES[op])


def test_alu_dispatch_cpu_path_is_plain_version():
    ops, a, b = map(torch.as_tensor, _planes(3, B=77))
    before = alu_dispatch.launches
    np.testing.assert_array_equal(alu_dispatch(ops, a, b).numpy(),
                                  alu_ref(ops, a, b).numpy())
    assert alu_dispatch.launches == before       # no kernel on the CPU


def test_alu_dispatch_checks_its_inputs():
    ops, a, b = map(torch.as_tensor, _planes(4, B=64))
    with pytest.raises(TypeError):
        alu_dispatch(ops, a.to(torch.int64), b)
    with pytest.raises(ValueError):
        alu_dispatch(ops, a[:4], b)
