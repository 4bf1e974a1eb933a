"""The port's zamba2 model against the reference, on the CPU.

The smoke ``zamba2-2.7b`` (4 layers, d_model 64, float32) is built in
both packages; the reference's weights are carried across with
``repro_torch.convert.model_params_from_jax``, so both compute the same
function.  Prefill logits and caches, and teacher-forced decode logits
(both sides fed the reference's greedy tokens), agree at
rtol = atol = 1e-4: float32 sums over the same contractions in another
order.  Prompts of 40 tokens (shorter than one SSD chunk) and 100 (a
padded last chunk).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.models import layers as RL, make_model as ref_make  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (get_config, get_smoke_config,  # noqa: E402
                                 list_archs)
from repro_torch.models import layers as L, make_model  # noqa: E402
from repro_torch.models.ssm import SSMState, dims  # noqa: E402

ARCH = "zamba2-2.7b"
TOL = 1e-4
CONTEXT = 128


def _pair(cfg_ref, cfg):
    """(reference model, its params, port model, port params with the
    reference's weights)."""
    rm = ref_make(cfg_ref)
    rp, _ = rm.init(jax.random.key(0))
    pm = make_model(cfg, device="cpu")
    pp = convert.model_params_from_jax(cfg, jax.tree.map(np.asarray, rp),
                                       into=pm.init(1))
    return rm, rp, pm, pp


@pytest.fixture(scope="module")
def f32():
    return _pair(ref_smoke(ARCH), get_smoke_config(ARCH))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _cache_leaves(c):
    return [c.ssm.h, c.ssm.conv, c.kv.k, c.kv.v, c.kv.pos]


def _close_norm(got, want, tol):
    """Relative Frobenius-norm error of a whole tensor."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w), (
        np.linalg.norm(g - w) / np.linalg.norm(w))


def _prefill_and_decode(pair, S, steps, tol, cache_close=_close):
    rm, rp, pm, pp = pair
    rng = np.random.default_rng(S)
    toks = rng.integers(0, pm.cfg.vocab, (1, S))
    rl, rc = rm.prefill(rp, {"tokens": jnp.asarray(toks)}, context=CONTEXT)
    pl, pc = pm.prefill(pp, {"tokens": torch.as_tensor(toks)},
                        context=CONTEXT)
    assert pl.shape == rl.shape
    _close(pl.float(), rl, tol)
    for want, got in zip(jax.tree.leaves(rc), _cache_leaves(pc)):
        assert tuple(got.shape) == want.shape
        cache_close(got.float(), np.asarray(want, np.float32), tol)
    for t in range(steps):
        tok = np.argmax(np.asarray(rl, np.float32)[:, -1], -1)[:, None]
        rl, rc = rm.decode(rp, jnp.asarray(tok), rc, jnp.int32(S + t))
        pl, pc = pm.decode(pp, torch.as_tensor(tok), pc, S + t)
        _close(pl.float(), rl, tol)
    for want, got in zip(jax.tree.leaves(rc), _cache_leaves(pc)):
        cache_close(got.float(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("S", [40, 100])
def test_prefill_and_teacher_forced_decode_match(f32, S):
    _prefill_and_decode(f32, S, steps=4, tol=TOL)


def test_bf16_prefill_and_decode_match():
    """bfloat16 activations.  The two frameworks round to bf16 at other
    places (XLA keeps fused elementwise chains in f32; the reference's
    attention rounds its scores and probabilities to bf16 where the
    kernel keeps f32), and the differences compound over the layers.
    So the float32 logits agree elementwise at 5e-2, a few bf16 ulps
    (bf16 epsilon is 7.8e-3) of logits of size one; the bf16 cache
    entries, where one element in thousands can sit a rounding step
    apart, agree as whole tensors at 3e-2 relative norm (four bf16
    epsilons)."""
    pair = _pair(ref_smoke(ARCH).replace(dtype="bfloat16"),
                 get_smoke_config(ARCH).replace(dtype="bfloat16"))

    def cache_close(got, want, tol):
        _close_norm(got, want, 3e-2)

    _prefill_and_decode(pair, 100, steps=2, tol=5e-2,
                        cache_close=cache_close)


def test_mamba2_forward_and_decode_match(f32):
    rm, rp, pm, pp = f32
    cfg = pm.cfg
    layer = jax.tree.map(lambda a: a[1, 0], rp["mamba"]["mix"])
    mixer = pp.layers[cfg.shared_attn_every].mix
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 100, cfg.d_model)).astype(np.float32)
    I, H, P, N = dims(cfg)
    h0 = rng.standard_normal((2, H, P, N)).astype(np.float32)
    conv0 = rng.standard_normal((2, cfg.ssm_conv - 1, I + 2 * N)
                                ).astype(np.float32)
    for state in (None, (h0, conv0)):
        rst = None if state is None else RS.SSMState(*map(jnp.asarray,
                                                          state))
        pst = None if state is None else SSMState(*map(torch.from_numpy,
                                                       state))
        ry, rs = RS.mamba2_forward(layer, cfg, jnp.asarray(x), rst)
        py, ps = mixer(torch.from_numpy(x), pst)
        _close(py, ry)
        _close(ps.h, rs.h)
        _close(ps.conv, rs.conv)
    xt = x[:, :1]
    ry, rs = RS.mamba2_decode(layer, cfg, jnp.asarray(xt), rs)
    py, ps = mixer.decode(torch.from_numpy(xt), ps)
    _close(py, ry)
    _close(ps.h, rs.h)


@pytest.mark.parametrize("S", [37, 64])
def test_attention_forward_matches(f32, S):
    rm, rp, pm, pp = f32
    cfg = pm.cfg
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    ry, (rk, rv) = RL.attention_forward(rp["shared"]["attn"], cfg,
                                        jnp.asarray(x), causal=True)
    py, (pk, pv) = L.attention_forward(pp.shared.attn, cfg,
                                       torch.from_numpy(x), causal=True)
    _close(py, ry)
    _close(pk, rk)
    _close(pv, rv)


def test_configs_match_reference():
    for mine, ref in ((get_config(ARCH), ref_get_config(ARCH)),
                      (get_smoke_config(ARCH), ref_smoke(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.hd,
            full.shared_attn_every) == (54, 2560, 32, 80, 6)


@pytest.mark.parametrize("arch", ref_list_archs())
def test_registry_equals_the_reference(arch):
    """Every architecture of the reference is registered, its full and
    smoke configs equal field for field, and both build a model (no
    weights are drawn)."""
    assert list_archs() == ref_list_archs()
    for mine, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_smoke_config(arch), ref_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert make_model(mine, device="cpu").cfg == mine
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config(arch + "-x")


def test_init_matches_reference_shapes_and_distributions(f32):
    rm, rp, pm, _ = f32
    fresh = pm.init(7)
    want = convert.model_params_from_jax(pm.cfg,
                                         jax.tree.map(np.asarray, rp))
    got = fresh.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    D = pm.cfg.d_model
    w = got["layers.0.mix.in_proj"]
    assert w.abs().max() <= 2.0 / np.sqrt(D) + 1e-6
    # a standard normal truncated to [-2, 2] has std 0.8796
    assert abs(float(w.std()) * np.sqrt(D) - 0.8796) < 0.03
    np.testing.assert_allclose(got["layers.0.mix.A_log"],
                               want["layers.0.mix.A_log"], rtol=1e-6)
    dt = torch.nn.functional.softplus(got["layers.0.mix.dt_bias"])
    assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 1e-1 + 1e-6)).all())
    assert not torch.equal(w, pm.init(8).state_dict()["layers.0.mix.in_proj"])
