"""The port's flash-attention wrapper on the CPU (its plain version)
against the reference's Pallas kernel in interpret mode.

Inputs are made with numpy from a seed and handed to both packages in
the model layout (q (B, S, H, hd), k/v (B, T, KV, hd)).  Tolerances are
those of tests/test_kernel_flash_attention.py: 2e-5 in float32, 2e-2 in
bfloat16.  A ragged S, which the Pallas kernel refuses (S % blk != 0),
is held to the reference's plain path (impl="ref").

The backward: the port's plain backward (``ref.attention_bwd_ref``,
torch's autograd, which the wrapper takes for CPU tensors) against
``jax.grad`` of the reference's plain attention, at 1e-5 in float32;
``torch.autograd.gradcheck`` in float64 on the autograd function; and a
wrapper whose launchers are stubbed to fail raises, with the plain
version never reached (no fallback from the kernels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.kernels.flash_attention.ops import attention as ref_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, S, T, H, KV, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]
    jax_in = [jnp.asarray(a, jnp.dtype(dtype)) for a in arrs]
    torch_in = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jax_in, torch_in


def _compare(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,dtype", [
    (2, 128, 4, 4, 32, True, None, "float32"),
    (2, 128, 4, 4, 32, False, None, "float32"),
    (1, 128, 4, 4, 32, True, None, "bfloat16"),
    (1, 128, 4, 4, 32, False, None, "bfloat16"),
    (1, 256, 2, 2, 16, True, 64, "float32"),
    (1, 128, 2, 2, 16, False, 32, "float32"),
    (2, 128, 4, 2, 16, True, None, "float32"),
    (1, 128, 4, 2, 16, True, None, "bfloat16"),
])
def test_matches_pallas_interpret(B, S, H, KV, hd, causal, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(S + hd + H * KV, B, S, S, H, KV, hd,
                                      dtype)
    want = ref_attention(jq, jk, jv, causal=causal, window=window,
                         impl="pallas_interpret", blk_q=64, blk_k=64)
    launches = attention.launches
    got = attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert attention.launches == launches     # the CPU never launches
    _compare(got, want, dtype)


@pytest.mark.parametrize("S,T,causal,window,dtype", [
    (100, 100, True, None, "float32"),
    (100, 100, False, None, "float32"),
    (77, 77, True, 20, "float32"),
    (100, 100, True, None, "bfloat16"),
    (40, 100, False, None, "float32"),
])
def test_ragged_matches_reference_plain_path(S, T, causal, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(S + T, 1, S, T, 4, 2, 16, dtype)
    want = ref_attention(jq, jk, jv, causal=causal, window=window,
                         impl="ref")
    _compare(attention(q, k, v, causal=causal, window=window), want, dtype)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="multiple of KV"):
        attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(TypeError):
        attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="window"):
        attention(q, q, q, window=0)


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window,dtype", [
    (2, 64, 64, 4, 4, 16, True, None, "float32"),
    (1, 100, 100, 4, 2, 16, True, None, "float32"),     # GQA, ragged S
    (1, 90, 90, 2, 2, 24, False, None, "float32"),
    (1, 128, 128, 2, 2, 16, True, 20, "float32"),      # window
    (1, 77, 77, 4, 1, 8, False, 33, "float32"),
    (1, 40, 100, 2, 2, 16, False, None, "float32"),    # S < T
    (1, 64, 64, 4, 2, 16, True, None, "bfloat16"),
])
def test_plain_backward_matches_jax_grad(B, S, T, H, KV, hd, causal, window,
                                         dtype):
    (jq, jk, jv), (q, k, v) = _inputs(3 * S + T + hd, B, S, T, H, KV, hd,
                                      dtype)
    dout = np.random.default_rng(S).standard_normal((B, S, H, hd)).astype(
        np.float32)
    jdo = jnp.asarray(dout, jnp.dtype(dtype))

    def f(a, b, c):
        out = ref_attention(a, b, c, causal=causal, window=window,
                            impl="ref")
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    launches = ops.attention_bwd.launches
    got = attention_bwd_ref(q, k, v, torch.from_numpy(dout).to(q.dtype),
                            causal=causal, window=window)
    assert ops.attention_bwd.launches == launches
    for g, w in zip(got, want):
        assert g.dtype == q.dtype and tuple(g.shape) == w.shape
        _compare(g, w, dtype) if dtype == "bfloat16" else \
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def test_wrapper_gradient_is_the_plain_backward():
    """On the CPU the autograd function's backward is attention_bwd_ref."""
    _, (q, k, v) = _inputs(5, 1, 50, 50, 4, 2, 16, "float32")
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    dout = torch.randn(1, 50, 4, 16, generator=torch.Generator().manual_seed(0))
    attention(q, k, v, causal=True, window=7).backward(dout)
    want = attention_bwd_ref(q, k, v, dout, causal=True, window=7)
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


@pytest.mark.parametrize("causal,window,KV", [(True, None, 1), (False, 3, 2),
                                              (True, 2, 2)])
def test_gradcheck_float64(causal, window, KV):
    g = torch.Generator().manual_seed(KV)
    q = torch.randn(1, 6, 2, 3, dtype=torch.float64, generator=g)
    k = torch.randn(1, 6, KV, 3, dtype=torch.float64, generator=g)
    v = torch.randn(1, 6, KV, 3, dtype=torch.float64, generator=g)
    ins = tuple(t.requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops._Attention.apply(a, b, c, causal, window, True),
        ins)


def test_no_fallback_when_the_kernels_fail(monkeypatch):
    """A tensor taken for the card's reaches the launchers and their
    failures surface: the plain versions are never tried."""
    def boom(*a, **k):
        raise RuntimeError("launch failed")

    def plain_reached(*a, **k):
        raise AssertionError("the plain version was reached")

    _, (q, k, v) = _inputs(1, 1, 32, 32, 2, 2, 16, "float32")
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "attention_plain", plain_reached)
    monkeypatch.setattr(ops, "attention_bwd_ref", plain_reached)
    monkeypatch.setattr(ops, "_launch", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        attention(q, k, v)
    # a forward that "launched", then a backward whose launch fails
    monkeypatch.setattr(ops, "_launch", lambda q, *a, lse=False, **k: (
        torch.zeros_like(q), torch.zeros(q.shape[0], q.shape[2], q.shape[1])
        if lse else None, None))
    monkeypatch.setattr(ops, "_launch_bwd", boom)
    q.requires_grad_(True)
    out = attention(q, k, v)
    with pytest.raises(RuntimeError, match="launch failed"):
        out.sum().backward()
