"""Shared by the port's transformer-family parity tests (CPU only).

``make_pair(arch)`` builds a smoke model in both packages with the same
weights: the reference's initial leaves, every one perturbed by seeded
numpy noise (so a zero bias or a unit norm scale that the port dropped or
swapped would show), carried across by ``repro_torch.convert``.  The
reference's config differs only in ``unroll_layers=True``: its layers
then run as a Python loop (the same function as its ``lax.scan``), so
each MoE call is traced on its own and can be recorded.  Reference calls
are jitted (a first call compiles in well under a second, where eager
dispatch compiles every primitive on its own), each through a new
function object so that it is traced under the recorder then open.

``record_moe_inputs`` records the input of every MoE call of both
packages; ``check_routing`` compares the experts each token chose, call
by call, before any logits are compared: a near-tie between the k-th and
the (k+1)-th expert flips a token's whole output, and the failure then
names the layer, the token and the probability gap.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import make_model as ref_make
from repro.models import moe as ref_moe
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import make_model
from repro_torch.models import moe

TRANSFORMER_ARCHS = ["llama3.2-1b", "granite-moe-1b-a400m", "qwen2-vl-7b",
                     "olmo-1b", "smollm-360m", "starcoder2-15b",
                     "mixtral-8x22b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "mixtral-8x22b"]
# float32 parity of whole models: the same contractions summed in another
# order
TOL = 1e-4
CONTEXT = 64


def perturb(tree, seed: int = 0):
    """Every leaf plus seeded normal noise: half the leaf's own spread,
    or 0.1 for a constant leaf (zeros, ones)."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a, np.float32)
        s = float(a.std())
        noise = rng.standard_normal(a.shape).astype(np.float32)
        return a + noise * (0.5 * s if s > 0 else 0.1)
    return jax.tree.map(one, tree)


def make_pair(arch: str, **overrides):
    """(reference model, its params (jnp), port model, port params with
    the reference's weights) for the smoke config with ``overrides``."""
    ref_cfg = ref_smoke(arch).replace(unroll_layers=True, **overrides)
    cfg = get_smoke_config(arch).replace(**overrides)
    rm = ref_make(ref_cfg)
    rp0 = jax.jit(lambda key: rm.init(key)[0])(jax.random.key(0))
    rp_np = perturb(rp0)
    rp = jax.tree.map(jnp.asarray, rp_np)
    pm = make_model(cfg, device="cpu")
    pp = convert.model_params_from_jax(cfg, rp_np, into=pm.init(1))
    return rm, rp, pm, pp


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def cache_leaves(c):
    """The leaves of a port cache (nested named tuples), in the order
    ``jax.tree.leaves`` gives the reference's."""
    if isinstance(c, tuple):
        return [leaf for t in c for leaf in cache_leaves(t)]
    return [c]


@contextlib.contextmanager
def record_moe_inputs(monkeypatch):
    """Yields (reference inputs, port inputs): the input x of every
    ``apply_moe`` call in either package while the context is open, as
    numpy / torch arrays, in call order.  The reference's are taken by an
    ordered ``jax.debug.callback``, so a call traced (jitted) while the
    context is open records when it runs."""
    ref_log, port_log = [], []
    ref_apply, port_apply = ref_moe.apply_moe, moe.apply_moe

    def ref_rec(p, cfg, x):
        jax.debug.callback(lambda v: ref_log.append(np.asarray(v)), x,
                           ordered=True)
        return ref_apply(p, cfg, x)

    def port_rec(p, cfg, x):
        port_log.append(x.detach().clone())
        return port_apply(p, cfg, x)

    with monkeypatch.context() as m:
        m.setattr(ref_moe, "apply_moe", ref_rec)
        m.setattr(moe, "apply_moe", port_rec)
        yield ref_log, port_log


def ref_topk(probs, k: int) -> np.ndarray:
    """The reference's iterative argmax (``moe._topk_dispatch``): the
    experts each token picks, (B, S, k), in pick order."""
    remaining, picks = probs, []
    for _ in range(k):
        idx = jnp.argmax(remaining, axis=-1)
        picks.append(np.asarray(idx))
        remaining = remaining * (1.0 - jax.nn.one_hot(
            idx, probs.shape[-1], dtype=probs.dtype))
    return np.stack(picks, -1)


def check_routing(ref_inputs, port_inputs, rp, pp, cfg, what: str) -> int:
    """Compares the experts chosen at every recorded MoE call (call i is
    layer i % n_layers); fails on the first token whose choice differs,
    naming the layer, the token and the gap between its k-th and
    (k+1)-th probability.  Returns the number of calls compared (0 for a
    config without experts, which records none)."""
    assert len(ref_inputs) == len(port_inputs), (len(ref_inputs),
                                                 len(port_inputs))
    assert (len(ref_inputs) > 0) == (cfg.family == "moe")
    k = cfg.top_k
    for call, (zr, zp) in enumerate(zip(ref_inputs, port_inputs)):
        layer = call % cfg.n_layers
        router = rp["layers"]["mlp"]["router"][layer]
        pr = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", jnp.asarray(zr, jnp.float32),
            router.astype(jnp.float32)), axis=-1)
        want = ref_topk(pr, k)
        got = moe.topk_experts(moe.router_probs(pp.layers[layer].mlp, zp),
                               k).numpy()
        assert got.shape == want.shape == zp.shape[:2] + (k,)
        if not np.array_equal(got, want):
            b, s = np.argwhere((got != want).any(-1))[0]
            top = np.sort(np.asarray(pr)[b, s])[::-1]
            gap = top[k - 1] - top[k] if k < top.size else float("inf")
            pytest.fail(f"{what}: MoE routing differs at layer {layer} "
                        f"(call {call}), batch row {b}, token {s}: port "
                        f"{got[b, s].tolist()} vs reference "
                        f"{want[b, s].tolist()}; gap between the k-th and "
                        f"(k+1)-th probability {gap:.3g}")
    return len(ref_inputs)


def prefill_and_decode(monkeypatch, rm, rp, pm, pp, S, steps, tol=TOL,
                        cache_close=close, seed=0, batch_extra=None):
    """Prefill an S-token prompt, then ``steps`` teacher-forced decode
    steps (both sides fed the reference's greedy tokens); the experts
    chosen at every MoE call are compared before anything else."""
    cfg = pm.cfg
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (1, S))
    extra = batch_extra or {}
    ref_batch = {"tokens": jnp.asarray(toks),
                 **{k: jnp.asarray(v) for k, v in extra.items()}}
    port_batch = {"tokens": torch.as_tensor(toks),
                  **{k: torch.as_tensor(v) for k, v in extra.items()}}
    with record_moe_inputs(monkeypatch) as logs:
        prefill = jax.jit(lambda p, b: rm.prefill(p, b, context=CONTEXT))
        decode = jax.jit(lambda p, t, c, i: rm.decode(p, t, c, i))
        rl, rc = prefill(rp, ref_batch)
        want, feed = [(rl, rc)], []
        for t in range(steps):
            feed.append(np.argmax(np.asarray(rl, np.float32)[:, -1],
                                  -1)[:, None])
            rl, rc = decode(rp, jnp.asarray(feed[-1]), rc, jnp.int32(S + t))
            want.append((rl, rc))
        pl, pc = pm.prefill(pp, port_batch, context=CONTEXT)
        got = [(pl, [t.clone() for t in cache_leaves(pc)])]
        for t in range(steps):
            pl, pc = pm.decode(pp, torch.as_tensor(feed[t]), pc, S + t)
            got.append((pl, [t.clone() for t in cache_leaves(pc)]))
        jax.effects_barrier()
    calls = check_routing(*logs, rp, pp, cfg, f"{cfg.name} S={S}")
    assert calls == (cfg.n_layers * (1 + steps) if cfg.family == "moe"
                     else 0)
    for step, ((rl, rc), (pl, pc)) in enumerate(zip(want, got)):
        assert pl.shape == rl.shape
        close(pl, rl, tol)
        if step in (0, steps):      # the prefill's caches and the last
            for w, g in zip(jax.tree.leaves(rc), pc):
                assert tuple(g.shape) == w.shape
                cache_close(g.float(), np.asarray(w, np.float32), tol)
