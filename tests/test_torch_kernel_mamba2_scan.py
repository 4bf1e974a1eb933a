"""The port's intra-chunk SSD wrapper on the CPU (its plain version)
against the reference's Pallas kernel in interpret mode, at the
tolerance of tests/test_kernel_mamba2_scan.py (1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.kernels.mamba2_scan.ops import ssd_intra_chunk as ref_ssd  # noqa: E402
from repro_torch.kernels.mamba2_scan.ops import ssd_intra_chunk  # noqa: E402


def _softplus(a):
    return np.log1p(np.exp(a))


def _inputs(seed, G, L, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, L, H, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((G, L, H))).astype(np.float32)
    # log-decays: negative, accumulating within the chunk
    cum = np.cumsum(-_softplus(rng.standard_normal((G, L, H))),
                    axis=1).astype(np.float32)
    Bm = rng.standard_normal((G, L, N)).astype(np.float32)
    Cm = rng.standard_normal((G, L, N)).astype(np.float32)
    return x, dt, cum, Bm, Cm


@pytest.mark.parametrize("G,L,H,P,N", [
    (3, 64, 4, 32, 16),
    (2, 64, 2, 16, 8),
    (2, 32, 3, 8, 16),
    (4, 40, 1, 64, 8),
])
def test_matches_pallas_interpret(G, L, H, P, N):
    arrs = _inputs(G * L + H * P + N, G, L, H, P, N)
    want = np.asarray(ref_ssd(*map(jnp.asarray, arrs),
                              impl="pallas_interpret"))
    launches = ssd_intra_chunk.launches
    got = ssd_intra_chunk(*map(torch.from_numpy, arrs))
    assert got.dtype == torch.float32 and got.shape == (G, L, H, P)
    assert ssd_intra_chunk.launches == launches   # the CPU never launches
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_bad_inputs():
    x, dt, cum, Bm, Cm = map(torch.from_numpy, _inputs(0, 1, 8, 2, 4, 4))
    with pytest.raises(ValueError, match="dt"):
        ssd_intra_chunk(x, dt[:, :4], cum, Bm, Cm)
    with pytest.raises(TypeError, match="float32"):
        ssd_intra_chunk(x.double(), dt, cum, Bm, Cm)
