"""The port's flash-attention wrapper on the CPU (its plain version)
against the reference's Pallas kernel in interpret mode.

Inputs are made with numpy from a seed and handed to both packages in
the model layout (q (B, S, H, hd), k/v (B, T, KV, hd)).  Tolerances are
those of tests/test_kernel_flash_attention.py: 2e-5 in float32, 2e-2 in
bfloat16.  A ragged S, which the Pallas kernel refuses (S % blk != 0),
is held to the reference's plain path (impl="ref").
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.kernels.flash_attention.ops import attention as ref_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402

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
