"""The port's Mixture-of-Experts layer against the reference's, on the CPU.

``_topk_dispatch`` and ``apply_moe`` at capacity factors 8.0 (the smoke
configs': nothing is dropped), 1.25 (the full configs') and 0.5, so that
tokens over an expert's capacity are dropped and the drops are compared
too; the chosen experts are compared before any output.  Dispatch tensors
must be equal (0/1 entries); combine weights agree at 1e-6 (the same f32
operations; a division may round differently); layer outputs at 1e-5
(float32 products over D and F summed in another order); whole smoke
models with drops at 1e-4 (TOL, as tests/test_torch_transformer.py).
The invariants of tests/test_moe.py hold for the port's dispatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.models import moe as RM  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

from .torch_lm_pairs import (MOE_ARCHS, check_routing, close,  # noqa: E402
                             make_pair, prefill_and_decode, ref_topk)

CAPACITY_FACTORS = [8.0, 1.25, 0.5]


def _probs(seed, B, S, E):
    logits = np.random.default_rng(seed).standard_normal(
        (B, S, E)).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), -1))


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("E,k", [(8, 2), (4, 2), (32, 8)])
def test_topk_dispatch_matches_reference(cf, E, k):
    B, S = 2, 16
    probs = _probs(E * 100 + k, B, S, E)
    cfg = get_smoke_config("granite-moe-1b-a400m").replace(
        n_experts=E, top_k=k, capacity_factor=cf)
    cap = moe.capacity(cfg, S)
    assert cap == max(int(S * k / E * cf), 1)
    rd, rc = RM._topk_dispatch(jnp.asarray(probs), k, cap)
    pd, pc = moe._topk_dispatch(torch.as_tensor(probs), k, cap)
    np.testing.assert_array_equal(
        moe.topk_experts(torch.as_tensor(probs), k).numpy(),
        ref_topk(jnp.asarray(probs), k))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=1e-6,
                               atol=1e-7)
    kept = float(pd.sum())
    if cf == 8.0:
        assert kept == B * S * k            # dropless
    if cf == 0.5:
        assert kept < B * S * k             # tokens dropped
        assert kept == float(np.asarray(rd).sum())


def test_ties_go_to_the_first_index():
    """Equal probabilities: both packages pick experts 0, 1, ... in turn,
    and each expert's queue fills in token order."""
    probs = np.full((1, 6, 4), 0.25, np.float32)
    got = moe.topk_experts(torch.as_tensor(probs), 2).numpy()
    assert (got == [0, 1]).all()
    np.testing.assert_array_equal(got, ref_topk(jnp.asarray(probs), 2))
    rd, _ = RM._topk_dispatch(jnp.asarray(probs), 2, 3)
    pd, _ = moe._topk_dispatch(torch.as_tensor(probs), 2, 3)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    assert float(pd[0, :, 0].sum()) == 3.0     # tokens 3-5 dropped


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(2, 8), st.integers(1, 4),
       st.integers(4, 32))
def test_dispatch_invariants(seed, E, k, S):
    """tests/test_moe.py's invariants, for the port's dispatch."""
    k = min(k, E)
    probs = torch.as_tensor(_probs(seed % 2**32, 2, S, E))
    cap = max(int(S * k / E * 1.25), 1)
    d, c = (t.numpy() for t in moe._topk_dispatch(probs, k, cap))
    assert set(np.unique(d)).issubset({0.0, 1.0})
    assert (d.sum(axis=1) <= 1.0 + 1e-6).all(), "queue slot collision"
    assert (d.sum(axis=(2, 3)) <= k + 1e-6).all()
    assert (c >= -1e-7).all()
    per_tok = c.sum(axis=(2, 3))
    assert (per_tok <= 1.0 + 1e-5).all()
    full = d.sum(axis=(2, 3)) == k
    np.testing.assert_allclose(per_tok[full], 1.0, rtol=1e-5)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_reference(monkeypatch, arch, cf):
    """One perturbed layer's MoE on (2, 16, D) inputs: the chosen experts,
    then the output (1e-5) and the aux loss (1e-6)."""
    rm, rp, pm, pp = _pair(arch)
    cfg = pm.cfg.replace(capacity_factor=cf)
    layer = 1
    rparams = jax.tree.map(lambda a: a[layer], rp["layers"]["mlp"])
    mod = pp.layers[layer].mlp
    x = np.random.default_rng(8).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    ry, raux = RM.apply_moe(rparams, rm.cfg.replace(capacity_factor=cf),
                            jnp.asarray(x))
    py, paux = moe.apply_moe(mod, cfg, torch.as_tensor(x))
    # the routing first: layer `layer` is call `layer` of a 2-layer stack
    zs = [x] * cfg.n_layers
    check_routing(zs, [torch.as_tensor(z) for z in zs], rp, pp, cfg,
                  f"{arch} cf={cf}")
    close(py, ry, 1e-5)
    close(paux, raux, 1e-6)
    assert float(paux) > 0.0
    d, _ = moe._topk_dispatch(moe.router_probs(mod, torch.as_tensor(x)),
                              cfg.top_k, moe.capacity(cfg, 16))
    if cf == 0.5:
        assert float(d.sum()) < 2 * 16 * cfg.top_k


_PAIRS = {}


def _pair(arch, cf=None):
    key = (arch, cf)
    if key not in _PAIRS:
        _PAIRS[key] = (make_pair(arch) if cf is None
                       else make_pair(arch, capacity_factor=cf))
    return _PAIRS[key]


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_smoke_model_with_drops_matches_reference(monkeypatch, arch, cf):
    """The whole smoke model at the real capacity factor 1.25 and at 0.5:
    a 20-token prompt drops tokens in prefill; 3 decode steps."""
    rm, rp, pm, pp = _pair(arch, cf)
    prefill_and_decode(monkeypatch, rm, rp, pm, pp, S=20, steps=3, seed=9)


def test_dropless_when_capacity_generous():
    """capacity >= S*k/E guarantees zero drops for any routing."""
    cfg = get_smoke_config("mixtral-8x22b")   # capacity_factor 8 in smoke
    gen = torch.Generator().manual_seed(0)
    layer = moe.MoE(cfg, gen, torch.device("cpu"))
    x = torch.randn(1, 16, cfg.d_model, generator=gen)
    d, _ = moe._topk_dispatch(moe.router_probs(layer, x), cfg.top_k,
                              moe.capacity(cfg, 16))
    assert float(d.sum()) == 16 * cfg.top_k
    y, aux = layer(x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux) > 0.0
    # one decoded token a row at the full configs' factor 1.25: capacity
    # 1, and a token's k experts are distinct, so nothing is dropped
    for arch in MOE_ARCHS:
        assert moe.capacity(get_config(arch), 1) == 1
