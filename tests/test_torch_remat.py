"""The port's remat "dots" policy against the reference's, on the CPU.

The reference's ``dots_with_no_batch_dims_saveable`` keeps the output of
every product without batch dimensions and recomputes the rest; the
port's policy (``models/transformer.py`` ``DOTS_SAVED``) keeps the
outputs of ``aten.mm`` and ``aten.addmm``, and writes every product
without batch dims as ``@`` against a 2-D view of the weight.

- Gradients under "dots" and "full" equal those under "none" bit for bit
  in one smoke config of each family (recomputation repeats the same
  float32 arithmetic on the CPU).
- The products the port keeps a layer equal the reference's
  ``dot_general``s without batch dims in that layer's jaxpr
  (``jax.make_jaxpr``), in number and in elements: llama3.2-1b,
  granite-moe-1b-a400m, whisper-small's encoder and decoder layers, an
  xLSTM pair (see ``test_saved_products_match_reference_jaxpr``).
- An MoE layer's recomputation routes every token to the experts its
  forward chose, from the same router probabilities bit for bit.
- With the launchers stubbed as the card runs them, a "dots" step
  launches the flash forward twice a layer (the forward and the
  recomputation) and its backward once a layer, keeping the log-sum-exp.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.models import encdec as RE  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models import xlstm_model as RX  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fo  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.train_step import param_tree  # noqa: E402

from .test_torch_train_families import batch_np, to_torch  # noqa: E402
from .torch_lm_pairs import make_pair  # noqa: E402

FAMILY_ARCHS = ["llama3.2-1b", "granite-moe-1b-a400m", "qwen2-vl-7b",
                "whisper-small", "xlstm-350m", "zamba2-2.7b"]


def grads_under(arch, remat, batch, state):
    cfg = get_smoke_config(arch).replace(remat=remat)
    model = make_model(cfg, device="cpu")
    params = model.init(0)
    params.load_state_dict(state)
    params.requires_grad_(True)
    loss, _ = model.loss(params, to_torch(batch))
    return loss.detach(), torch.autograd.grad(
        loss, list(param_tree(params).values()))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_dots_and_full_give_the_gradients_of_none(arch):
    cfg = get_smoke_config(arch)
    state = make_model(cfg, device="cpu").init(5).state_dict()
    batch = batch_np(cfg, 0, S=20)
    loss, want = grads_under(arch, "none", batch, state)
    for remat in ("dots", "full"):
        got_loss, got = grads_under(arch, remat, batch, state)
        assert torch.equal(got_loss, loss), remat
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# What "dots" keeps, against the reference's jaxpr
# ---------------------------------------------------------------------------

def _subjaxprs(eqn):
    for v in eqn.params.values():
        for sub in (v if isinstance(v, (tuple, list)) else (v,)):
            if hasattr(sub, "eqns"):
                yield sub
            elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                yield sub.jaxpr


def batch_free_dots(jaxpr, times: int = 1):
    """(count, output elements) of the ``dot_general``s without batch
    dimensions in ``jaxpr`` and every jaxpr inside it, each counted as
    often as it runs (a scan's body ``length`` times)."""
    n = elems = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            _, (lb, rb) = eqn.params["dimension_numbers"]
            if not lb and not rb:
                n += times
                elems += times * math.prod(eqn.outvars[0].aval.shape)
        inner = times * (eqn.params["length"]
                         if eqn.primitive.name == "scan" else 1)
        for sub in _subjaxprs(eqn):
            a, b = batch_free_dots(sub, inner)
            n, elems = n + a, elems + b
    return n, elems


def port_saved(fn, cfg, *inputs):
    """(count, output elements) of the products ``remat_wrap`` keeps when
    ``fn`` runs under "dots" with a gradient wanted."""
    kept = [0, 0]
    policy = T.dots_policy

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == T.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2:]          # mm(a, b), addmm(bias, a, b)
            kept[0] += 1
            kept[1] += a.shape[0] * b.shape[1]
        return out

    T.dots_policy = counting
    try:
        y = T.remat_wrap(fn, cfg)(*inputs)
        y.float().sum().backward()
    finally:
        T.dots_policy = policy
    return tuple(kept)


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


B, S = 2, 10


def _x(cfg, rng, n=S):
    return rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)


def case_transformer(arch):
    rm, rp, pm, pp = make_pair(arch, remat="dots")
    cfg = rm.cfg
    x = _x(cfg, np.random.default_rng(0))
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    want = batch_free_dots(jax.make_jaxpr(
        lambda pl, x: RT._layer_train(pl, cfg, x, pos))(
            _layer(rp["layers"]), jnp.asarray(x)).jaxpr)
    pp.requires_grad_(True)
    tpos = torch.arange(S).expand(B, S)
    got = port_saved(lambda x: pp.layers[0].train_forward(x, tpos)[0],
                     pm.cfg, torch.as_tensor(x).requires_grad_(True))
    return got, want


def case_whisper(which):
    rm, rp, pm, pp = make_pair("whisper-small", remat="dots")
    cfg = rm.cfg
    rng = np.random.default_rng(1)
    x, enc = _x(cfg, rng), _x(cfg, rng, cfg.enc_seq)
    pp.requires_grad_(True)
    if which == "encoder":
        # the reference's encoder layer is a closure of ``encode``: its
        # jaxpr over the whole stack, a layer's share of it
        n, e = batch_free_dots(jax.make_jaxpr(
            lambda p, f: RE.encode(p, cfg, f))(rp, jnp.asarray(enc)).jaxpr)
        L = cfg.n_enc_layers
        assert n % L == 0 and e % L == 0
        want = (n // L, e // L)
        got = port_saved(pp.enc_layers[0], pm.cfg,
                         torch.as_tensor(enc).requires_grad_(True))
        return got, want
    want = batch_free_dots(jax.make_jaxpr(
        lambda pl, x, e: RE._dec_layer(pl, cfg, x, e))(
            _layer(rp["dec_layers"]), jnp.asarray(x),
            jnp.asarray(enc)).jaxpr)
    got = port_saved(
        lambda x: pp.dec_layers[0].train_forward(
            x, torch.as_tensor(enc).requires_grad_(True)),
        pm.cfg, torch.as_tensor(x).requires_grad_(True))
    return got, want


def case_xlstm():
    rm, rp, pm, pp = make_pair("xlstm-350m", remat="dots")
    cfg = rm.cfg
    x = _x(cfg, np.random.default_rng(2))
    n, e = batch_free_dots(jax.make_jaxpr(
        lambda pl, x: RX._pair_fwd(pl, cfg, x)[0])(
            _layer(rp["pairs"]), jnp.asarray(x)).jaxpr)
    pp.requires_grad_(True)
    got = port_saved(pp.pairs[0].train_forward, pm.cfg,
                     torch.as_tensor(x).requires_grad_(True))
    # the reference's sLSTM takes x_t @ wx inside its scan, S products of
    # (B, 4D); the port takes x @ wx once over the sequence (the same
    # values, one product of (B, S, 4D)): S - 1 fewer products, the same
    # elements kept
    return got, (n - (S - 1), e)


CASES = {"llama3.2-1b": lambda: case_transformer("llama3.2-1b"),
         "granite-moe-1b-a400m":
             lambda: case_transformer("granite-moe-1b-a400m"),
         "whisper-small encoder": lambda: case_whisper("encoder"),
         "whisper-small decoder": lambda: case_whisper("decoder"),
         "xlstm-350m pair": case_xlstm}
# products without batch dims a layer: q, k, v, the output projection
# and the MLP's (3 SwiGLU, 2 GELU); the MoE's router instead of its MLP
# (the experts' einsums have the expert dim as a batch dim); whisper's
# decoder has two attentions; an xLSTM pair q, k, v, the gates, the
# output gate and projection of the mLSTM, then the sLSTM's input
# product, one recurrent product a step and its projection
WANT_COUNT = {"llama3.2-1b": 7, "granite-moe-1b-a400m": 5,
              "whisper-small encoder": 6, "whisper-small decoder": 10,
              "xlstm-350m pair": 6 + 1 + S + 1}


@pytest.mark.parametrize("case", list(CASES))
def test_saved_products_match_reference_jaxpr(case):
    got, want = CASES[case]()
    assert got == want, (case, got, want)
    assert got[0] == WANT_COUNT[case]


# ---------------------------------------------------------------------------
# The MoE's routing under recomputation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x22b"])
def test_moe_recomputation_routes_as_the_forward(arch, remat, monkeypatch):
    """Every router call of a training step is recorded: under both
    policies each layer's router runs in the forward and again in the
    backward's recomputation (layers in reverse order); the probabilities
    are equal bit for bit and so are the experts chosen."""
    cfg = get_smoke_config(arch).replace(remat=remat)
    model = make_model(cfg, device="cpu")
    params = model.init(2).requires_grad_(True)
    log = []
    router_probs = moe.router_probs

    def recorded(p, x):
        probs = router_probs(p, x)
        log.append(probs.detach().clone())
        return probs

    monkeypatch.setattr(moe, "router_probs", recorded)
    loss, _ = model.loss(params, to_torch(batch_np(cfg, 0, S=32)))
    n = cfg.n_layers
    assert len(log) == n
    torch.autograd.grad(loss, list(param_tree(params).values()))
    assert len(log) == 2 * n
    for layer in range(n):
        fwd, again = log[layer], log[2 * n - 1 - layer]
        assert torch.equal(fwd, again), layer
        assert torch.equal(moe.topk_experts(fwd, cfg.top_k),
                           moe.topk_experts(again, cfg.top_k))


# ---------------------------------------------------------------------------
# Kernel launches of a "dots" step
# ---------------------------------------------------------------------------

def test_dots_step_launches_flash_twice_a_layer(monkeypatch):
    """The launchers stubbed by the plain versions, as on the card: a
    llama step under "dots" launches the flash forward (with lse) twice a
    layer and the backward (two kernels) once a layer; serving launches
    the forward once a layer, without lse."""
    calls = []

    def flash(q, k, v, causal, window, *, lse=False, out=None, rows=None,
              out32=None):
        calls.append(("flash", lse))
        return fo.attention_plain(q, k, v, causal=causal, window=window), \
            (torch.zeros(q.shape[0], q.shape[2], q.shape[1]) if lse
             else None), None

    def flash_bwd(q, k, v, dout, lse, causal, window, *, out32=None,
                  grads=None):
        calls.append(("flash_bwd", lse is not None))
        return fo.attention_bwd_ref(q, k, v, dout, causal=causal,
                                    window=window)

    monkeypatch.setattr(fo, "_on_card", lambda t: True)
    monkeypatch.setattr(fo, "_launch", flash)
    monkeypatch.setattr(fo, "_launch_bwd", flash_bwd)
    cfg = get_smoke_config("llama3.2-1b").replace(remat="dots")
    model = make_model(cfg, device="cpu")
    params = model.init(0)
    batch = to_torch(batch_np(cfg, 0, S=16))
    model.prefill(params, {"tokens": batch["tokens"]}, context=32)
    assert calls == [("flash", False)] * cfg.n_layers
    calls.clear()
    params.requires_grad_(True)
    loss, _ = model.loss(params, batch)
    assert calls == [("flash", True)] * cfg.n_layers
    loss.backward()
    assert calls.count(("flash", True)) == 2 * cfg.n_layers
    assert calls.count(("flash_bwd", True)) == cfg.n_layers
    assert len(calls) == 3 * cfg.n_layers
