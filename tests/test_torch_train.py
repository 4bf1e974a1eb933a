"""The port's training path against the reference's, on the CPU.

The smoke ``zamba2-2.7b`` (4 layers, d_model 64, float32) is built in
both packages and the reference's initial train state (weights, zero
moments, step 0) is carried across with
``repro_torch.convert.train_state_from_jax``, so both train the same
function on the same batch.  The loss and its metrics agree at 1e-5;
every gradient, and the parameters, moments, learning rate and gradient
norm after 3 AdamW steps, at rtol 2e-4 / atol 2e-6, the tolerance of
``tests/test_train_substrate.py`` (float32 sums in another order, the
SSD's and attention's gradients through their plain backward).  The
optimizer and compression units mirror ``tests/test_train_substrate.py``
case for case, against the reference functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import make_model as ref_make  # noqa: E402
from repro.models.model import lm_loss as ref_lm_loss  # noqa: E402
from repro.train import compression as rcomp  # noqa: E402
from repro.train import optim as roptim  # noqa: E402
from repro.train.train_step import (  # noqa: E402
    make_train_step as ref_make_step, train_state_init as ref_state_init)
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models.model import lm_loss  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    make_train_step, param_tree)

ARCH = "zamba2-2.7b"
RTOL, ATOL = 2e-4, 2e-6
# eps 1e-3 where parameters are compared after steps.  Adam moves a
# weight by lr * g / (|g| + eps) at its first step: with the default eps
# of 1e-8 a weight whose gradient is ~1e-8 moves by ~lr whatever the
# sign of its float32 noise (gradients equal to 2e-7 left 11 of 32,768
# head weights 3e-5 apart after 3 steps at lr 1e-3), while eps = 1e-3
# bounds the gain from a gradient's error to a weight's at lr / eps = 1.
# test_default_eps_steps_match_reference_but_params holds the default
# eps on everything but the parameters.
OPT = dict(lr=1e-3, warmup_steps=0, schedule="constant", eps=1e-3)


def _flat(tree, prefix=""):
    """{dotted path: numpy} of a nested dict (the reference's layout)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close_trees(got, want, rtol=RTOL, atol=ATOL):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for name in w:
        np.testing.assert_allclose(g[name], w[name], rtol=rtol, atol=atol,
                                   err_msg=name)


def _batch(cfg, seed=0, B=2, S=100):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _pair(compress=False, opt=OPT):
    """(reference model, its initial state, port model, port state with
    the reference's state)."""
    rm = ref_make(ref_smoke(ARCH))
    rs, _ = ref_state_init(rm, jax.random.key(0), roptim.AdamWConfig(**opt),
                           compress=compress)
    pm = make_model(get_smoke_config(ARCH), device="cpu")
    ps = convert.train_state_from_jax(pm.cfg, jax.tree.map(np.asarray, rs))
    return rm, rs, pm, ps


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_state_carries_across_both_ways(pair):
    rm, rs, pm, ps = pair
    back = convert.train_state_to_jax(pm.cfg, ps)
    _close_trees(back.params, jax.tree.map(np.asarray, rs.params), 0, 0)
    _close_trees(back.opt.mu, jax.tree.map(np.asarray, rs.opt.mu), 0, 0)
    assert int(back.opt.step) == int(rs.opt.step) == 0
    assert back.ef is None and rs.ef is None


def test_loss_and_metrics_match_reference(pair):
    rm, rs, pm, ps = pair
    batch = _batch(pm.cfg)
    want_loss, want = rm.loss(rs.params, _to_jax(batch))
    with torch.no_grad():
        got_loss, got = pm.loss(ps.params, _to_torch(batch))
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_every_gradient_matches_jax_grad(pair):
    rm, rs, pm, ps = pair
    batch = _batch(pm.cfg, seed=1)
    want = jax.grad(lambda p: rm.loss(p, _to_jax(batch))[0])(rs.params)
    tree = param_tree(ps.params)
    loss, _ = pm.loss(ps.params, _to_torch(batch))
    got = dict(zip(tree, torch.autograd.grad(loss, list(tree.values()))))
    _close_trees(convert.model_params_to_jax(pm.cfg, got),
                 jax.tree.map(np.asarray, want))


def _run_both(steps, *, microbatch=None, compress=False, opt=OPT):
    rm, rs, pm, ps = _pair(compress=compress, opt=opt)
    ref_step = jax.jit(ref_make_step(rm, roptim.AdamWConfig(**opt),
                                     microbatch=microbatch,
                                     compress_grads=compress))
    step = make_train_step(pm, optim.AdamWConfig(**opt),
                           microbatch=microbatch, compress_grads=compress)
    for i in range(steps):
        batch = _batch(pm.cfg, seed=10 + i, B=4, S=64)
        rs, rmet = ref_step(rs, _to_jax(batch))
        ps, pmet = step(ps, _to_torch(batch))
        assert set(pmet) == set(rmet)
        for k in ("lr", "grad_norm", "loss", "nll"):
            np.testing.assert_allclose(float(pmet[k]), float(rmet[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    return rs, ps, pm


def _close_states(ps, rs, cfg, params=True):
    got = convert.train_state_to_jax(cfg, ps)
    want = jax.tree.map(np.asarray, rs)
    assert int(got.opt.step) == int(want.opt.step)
    if params:
        _close_trees(got.params, want.params)
    _close_trees(got.opt.mu, want.opt.mu)
    _close_trees(got.opt.nu, want.opt.nu)
    if want.ef is not None:
        _close_trees(got.ef.residual, want.ef.residual)


def test_three_adamw_steps_match_reference():
    rs, ps, pm = _run_both(3)
    _close_states(ps, rs, pm.cfg)
    assert int(ps.opt.step) == 3


def test_default_eps_steps_match_reference_but_params():
    """The default eps (1e-8): loss, lr, grad_norm, step and both moments
    after 3 steps at the tolerance; parameters are left to the tests
    above (see OPT)."""
    rs, ps, pm = _run_both(3, opt=dict(OPT, eps=1e-8))
    _close_states(ps, rs, pm.cfg, params=False)


def test_three_steps_with_warmup_and_cosine_match_reference():
    """The default schedule (warmup, cosine decay, weight decay) as the
    trainer builds it."""
    rs, ps, pm = _run_both(3, opt=dict(lr=1e-3, warmup_steps=2,
                                       total_steps=6, eps=1e-3))
    _close_states(ps, rs, pm.cfg)


def test_microbatch_matches_reference_and_full_batch():
    rs, ps, pm = _run_both(2, microbatch=2)
    _close_states(ps, rs, pm.cfg)
    _, full, _ = _run_both(2)
    _close_trees(convert.train_state_to_jax(pm.cfg, full).params,
                 convert.train_state_to_jax(pm.cfg, ps).params)


def test_compressed_steps_match_reference_with_residual():
    """2 steps with int8 error-feedback compression.  Against the
    reference's run: loss, lr and grad_norm at the tolerance (checked in
    _run_both).  The state: the port's step against the reference's
    ef_compress_grads and adamw_update applied to the port's own
    gradients, residual included -- int8 rounding turns float32 noise in
    a gradient near a rounding tie into a whole quantization step, so the
    state is held to the reference's functions on equal inputs, and the
    gradients to jax.grad in test_every_gradient_matches_jax_grad."""
    _run_both(2, compress=True)
    rm, rs, pm, ps = _pair(compress=True)
    cfg = pm.cfg
    step = make_train_step(pm, optim.AdamWConfig(**OPT), compress_grads=True)
    ref_cfg = roptim.AdamWConfig(**OPT)
    for i in range(2):
        batch = _batch(cfg, seed=20 + i, B=4, S=64)
        tree = param_tree(ps.params)
        loss, _ = pm.loss(ps.params, _to_torch(batch))
        grads = dict(zip(tree, torch.autograd.grad(loss, list(tree.values()))))
        before = convert.train_state_to_jax(cfg, ps)
        g_ref, ef_ref = rcomp.ef_compress_grads(
            convert.model_params_to_jax(cfg, grads),
            rcomp.EFState(before.ef.residual))
        p_ref, opt_ref, met = roptim.adamw_update(
            ref_cfg, before.params, g_ref,
            roptim.OptState(jnp.asarray(before.opt.step), before.opt.mu,
                            before.opt.nu))
        ps, pmet = step(ps, _to_torch(batch))
        after = convert.train_state_to_jax(cfg, ps)
        np.testing.assert_allclose(float(pmet["grad_norm"]),
                                   float(met["grad_norm"]), rtol=RTOL)
        _close_trees(after.ef.residual, jax.tree.map(np.asarray,
                                                     ef_ref.residual))
        _close_trees(after.params, jax.tree.map(np.asarray, p_ref))
        _close_trees(after.opt.mu, jax.tree.map(np.asarray, opt_ref.mu))
        _close_trees(after.opt.nu, jax.tree.map(np.asarray, opt_ref.nu))
    assert any(float(t.abs().max()) > 0 for t in ps.ef.residual.values())


def test_lm_loss_gather_equals_onehot_and_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 40)).astype(np.float32) * 3
    logits[..., 33:] = -1e9                   # padded vocabulary columns
    labels = rng.integers(0, 33, (2, 7))
    aux = np.float32(0.25)
    want_loss, want = ref_lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(aux))
    for impl in ("gather", "onehot"):
        loss, got = lm_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                            torch.as_tensor(aux), ce_impl=impl)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6, err_msg=f"{impl} {k}")
    a = lm_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                torch.as_tensor(aux), ce_impl="gather")[0]
    b = lm_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                torch.as_tensor(aux), ce_impl="onehot")[0]
    np.testing.assert_allclose(float(a), float(b), rtol=1e-7)


def test_remat_full_gives_the_gradients_of_none():
    cfg = get_smoke_config(ARCH)
    batch = _to_torch(_batch(cfg, seed=2, S=70))
    grads = {}
    for remat in ("none", "full"):
        m = make_model(cfg.replace(remat=remat), device="cpu")
        params = m.init(0).requires_grad_(True)
        tree = param_tree(params)
        loss, _ = m.loss(params, batch)
        grads[remat] = torch.autograd.grad(loss, list(tree.values()))
    for a, b in zip(grads["none"], grads["full"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_dots_gradients_match_reference():
    """remat "dots" in both packages: the loss and every gradient against
    ``jax.grad`` (the reference keeps its products without batch dims,
    the port its ``aten.mm`` outputs; ``tests/test_torch_remat.py``)."""
    rm = ref_make(ref_smoke(ARCH).replace(remat="dots"))
    rs, _ = ref_state_init(rm, jax.random.key(0), roptim.AdamWConfig(**OPT))
    pm = make_model(get_smoke_config(ARCH).replace(remat="dots"),
                    device="cpu")
    ps = convert.train_state_from_jax(pm.cfg, jax.tree.map(np.asarray, rs))
    batch = _batch(pm.cfg, seed=4, S=70)
    (want_loss, _), want = jax.jit(jax.value_and_grad(
        lambda p, b: rm.loss(p, b), has_aux=True))(rs.params,
                                                   _to_jax(batch))
    tree = param_tree(ps.params)
    loss, _ = pm.loss(ps.params, _to_torch(batch))
    got = dict(zip(tree, torch.autograd.grad(loss, list(tree.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    _close_trees(convert.model_params_to_jax(pm.cfg, got),
                 jax.tree.map(np.asarray, want))


# ---------------------------------------------------------------------------
# Optimizer and compression units (tests/test_train_substrate.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_reference(schedule):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1,
              schedule=schedule)
    got = [float(optim.lr_at(optim.AdamWConfig(**kw), s))
           for s in range(0, 121, 5)]
    want = [float(roptim.lr_at(roptim.AdamWConfig(**kw), jnp.asarray(s)))
            for s in range(0, 121, 5)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if schedule == "cosine":
        assert got[0] == 0.0 and abs(got[2] - 1.0) < 1e-6
        assert got[20] == pytest.approx(0.1, abs=1e-3)


def test_adamw_minimizes_quadratic():
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, schedule="constant")
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optim.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = optim.adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(4)
    p = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "scale": rng.standard_normal(5).astype(np.float32)}
    kw = dict(lr=0.05, weight_decay=0.3, warmup_steps=2, total_steps=9,
              clip_norm=0.5)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    rst = roptim.adamw_init(rp)
    tp = {k: torch.as_tensor(v.copy()) for k, v in p.items()}
    tst = optim.adamw_init(tp)
    for i in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        rp, rst, rmet = roptim.adamw_update(
            roptim.AdamWConfig(**kw), rp, {k: jnp.asarray(v)
                                           for k, v in g.items()}, rst)
        tp, tst, tmet = optim.adamw_update(
            optim.AdamWConfig(**kw), tp, {k: torch.as_tensor(v)
                                          for k, v in g.items()}, tst)
        for k in rp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tst.nu[k].numpy(),
                                       np.asarray(rst.nu[k]), rtol=1e-6)
        np.testing.assert_allclose(float(tmet["lr"]), float(rmet["lr"]),
                                   rtol=1e-7)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(rmet["grad_norm"]), rtol=1e-6)
    assert int(tst.step) == int(rst.step) == 5


def test_weight_decay_only_on_matrices():
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=0,
                            schedule="constant")
    params = {"w": torch.ones(4, 4), "scale": torch.ones(4)}
    state = optim.adamw_init(params)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, _, _ = optim.adamw_update(cfg, params, zeros, state)
    assert float(p2["w"].max()) < 1.0          # decayed
    assert float(p2["scale"].max()) == 1.0     # vectors not decayed


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, gn = optim.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)
    want = roptim.global_norm({"a": jnp.full((10,), 10.0),
                               "b": jnp.arange(6.0).reshape(2, 3)})
    got = optim.global_norm({"a": torch.full((10,), 10.0),
                             "b": torch.arange(6.0).reshape(2, 3)})
    assert float(got) == pytest.approx(float(want), rel=1e-7)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 1023), (2, 1024), (3, 1025),
                                    (4, 4000), (5, 3000)])
def test_int8_quantization_matches_reference_and_bound(seed, n):
    x = (np.random.default_rng(seed).standard_normal(n) * 3).astype(
        np.float32)
    y = comp.compress_decompress(torch.as_tensor(x)).numpy()
    q, s = comp.quantize_int8(torch.as_tensor(x))
    rq, rs = rcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        y, np.asarray(rcomp.compress_decompress(jnp.asarray(x))))
    # per-block max-scale int8: error bounded by scale/2 = max|x|/254
    assert np.abs(y - x).max() <= float(np.abs(x).max()) / 254 + 1e-6


def test_error_feedback_reduces_bias():
    """With EF the mean compressed gradient converges to the true mean;
    the residual equals the reference's step for step."""
    g = {"w": torch.full((1024,), 1e-4)}
    rg = {"w": jnp.full((1024,), 1e-4)}
    ef, ref = comp.ef_init(g), rcomp.ef_init(rg)
    tot = torch.zeros(1024)
    for _ in range(50):
        gq, ef = comp.ef_compress_grads(g, ef)
        rgq, ref = rcomp.ef_compress_grads(rg, ref)
        np.testing.assert_array_equal(gq["w"].numpy(), np.asarray(rgq["w"]))
        np.testing.assert_array_equal(ef.residual["w"].numpy(),
                                      np.asarray(ref.residual["w"]))
        tot = tot + gq["w"]
    np.testing.assert_allclose((tot / 50).numpy(), 1e-4, rtol=0.2)
