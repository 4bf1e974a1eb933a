"""The port's intra-chunk SSD wrapper on the CPU (its plain version)
against the reference's Pallas kernel in interpret mode, at the
tolerance of tests/test_kernel_mamba2_scan.py (1e-5).

The backward: the port's plain backward (``ref.intra_chunk_bwd_ref``,
torch's autograd, which the wrapper takes for CPU tensors) against
``jax.grad`` of the reference's plain version at 1e-5;
``torch.autograd.gradcheck`` in float64 on the autograd function; and a
wrapper whose launchers are stubbed to fail raises, with the plain
version never reached."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.kernels.mamba2_scan.ops import ssd_intra_chunk as ref_ssd  # noqa: E402
from repro_torch.kernels.mamba2_scan import ops  # noqa: E402
from repro_torch.kernels.mamba2_scan.ops import ssd_intra_chunk  # noqa: E402
from repro_torch.kernels.mamba2_scan.ref import intra_chunk_bwd_ref  # noqa: E402


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


@pytest.mark.parametrize("G,L,H,P,N", [
    (3, 64, 4, 32, 16), (2, 40, 3, 8, 16), (2, 17, 2, 5, 3), (1, 1, 2, 4, 4),
])
def test_plain_backward_matches_jax_grad(G, L, H, P, N):
    arrs = _inputs(7 * G + L + P, G, L, H, P, N)
    dy = np.random.default_rng(L).standard_normal((G, L, H, P)).astype(
        np.float32)
    want = jax.grad(lambda *a: jnp.sum(ref_ssd(*a, impl="ref") * dy),
                    argnums=tuple(range(5)))(*map(jnp.asarray, arrs))
    launches = ops.ssd_intra_chunk_bwd.launches
    got = intra_chunk_bwd_ref(*map(torch.from_numpy, arrs),
                              torch.from_numpy(dy))
    assert ops.ssd_intra_chunk_bwd.launches == launches
    for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_wrapper_gradient_is_the_plain_backward():
    arrs = [torch.from_numpy(a).requires_grad_(True)
            for a in _inputs(3, 2, 30, 3, 8, 4)]
    dy = torch.randn(2, 30, 3, 8, generator=torch.Generator().manual_seed(1))
    ssd_intra_chunk(*arrs).backward(dy)
    want = intra_chunk_bwd_ref(*arrs, dy)
    for t, w in zip(arrs, want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


def test_plain_backward_is_finite_where_the_decay_overflows():
    """cum falling by more than 88 within a chunk makes exp(cum_i - cum_j)
    overflow above the diagonal; the forward masks it, and so must the
    gradient (0, not 0 * inf)."""
    x, dt, cum, Bm, Cm = map(torch.from_numpy, _inputs(4, 1, 64, 2, 4, 4))
    cum = cum * 20.0
    got = intra_chunk_bwd_ref(x, dt, cum, Bm, Cm, torch.ones_like(x))
    assert all(bool(torch.isfinite(g).all()) for g in got)


def test_gradcheck_float64():
    g = torch.Generator().manual_seed(2)
    G, L, H, P, N = 2, 5, 2, 3, 2
    ins = (torch.randn(G, L, H, P, dtype=torch.float64, generator=g),
           torch.rand(G, L, H, dtype=torch.float64, generator=g),
           torch.cumsum(-torch.rand(G, L, H, dtype=torch.float64,
                                    generator=g), 1),
           torch.randn(G, L, N, dtype=torch.float64, generator=g),
           torch.randn(G, L, N, dtype=torch.float64, generator=g))
    ins = tuple(t.requires_grad_(True) for t in ins)
    assert torch.autograd.gradcheck(
        lambda *a: ops._SSD.apply(*a, True), ins)


def test_no_fallback_when_the_kernels_fail(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("launch failed")

    def plain_reached(*a, **k):
        raise AssertionError("the plain version was reached")

    arrs = list(map(torch.from_numpy, _inputs(1, 1, 16, 2, 4, 4)))
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "intra_chunk_ref", plain_reached)
    monkeypatch.setattr(ops, "intra_chunk_bwd_ref", plain_reached)
    monkeypatch.setattr(ops, "_launch", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        ssd_intra_chunk(*arrs)
    monkeypatch.setattr(ops, "_launch", lambda x, *a, **k: torch.zeros_like(x))
    monkeypatch.setattr(ops, "_launch_bwd", boom)
    arrs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="launch failed"):
        ssd_intra_chunk(*arrs).sum().backward()
