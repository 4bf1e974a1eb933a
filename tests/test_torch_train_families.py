"""Training every non-hybrid family in the port against the reference, on
the CPU.

The nine smoke configs of the dense, MoE, VLM, encoder-decoder and xLSTM
families, float32, with ``remat="dots"`` in both packages (the setting
six of their full configs train with).  Both start from the same
weights: the reference's initial leaves perturbed with seeded numpy
noise, carried across by ``repro_torch.convert``
(``tests/torch_lm_pairs.py``); batches come from the data pipeline the
two packages share (seeded numpy: tokens, and the VLM's patch embeds and
M-RoPE positions, the encoder-decoder's frames).  The loss and its
metrics agree at 1e-5; every gradient, against ``jax.grad``, at the
tolerance of ``tests/test_torch_train.py`` (rtol 2e-4 / atol 2e-6:
float32 sums in another order).  Before any number of an MoE config is
compared, the experts every token chose are (``check_routing``).  The
optimizer steps are ``tests/test_torch_train_steps.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro_torch import convert  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.train.train_step import param_tree  # noqa: E402

from .torch_lm_pairs import (check_routing, make_pair,  # noqa: E402
                             record_moe_inputs)

ARCHS = ["llama3.2-1b", "granite-moe-1b-a400m", "qwen2-vl-7b", "olmo-1b",
         "smollm-360m", "starcoder2-15b", "mixtral-8x22b", "whisper-small",
         "xlstm-350m"]
RTOL, ATOL = 2e-4, 2e-6


def flat(tree, prefix=""):
    """{dotted path: numpy} of a nested dict (the reference's layout)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def close_trees(got, want, rtol=RTOL, atol=ATOL, what=""):
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    for name in w:
        np.testing.assert_allclose(g[name], w[name], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def batch_np(cfg, step, B=2, S=24, seed=0):
    """A training batch of the shared pipeline: (B, S) tokens and labels,
    and the family's extras."""
    return make_stream(cfg, S, B, seed=seed).batch_at(step)


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def dots_pair(arch):
    return make_pair(arch, remat="dots")


def port_grads(pm, params, batch):
    tree = param_tree(params)
    loss, metrics = pm.loss(params, to_torch(batch))
    grads = torch.autograd.grad(loss, list(tree.values()))
    return loss, metrics, dict(zip(tree, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch, monkeypatch):
    rm, rp, pm, pp = dots_pair(arch)
    cfg = pm.cfg
    pp.requires_grad_(True)
    batch = batch_np(cfg, 0)
    if cfg.family == "moe":
        with record_moe_inputs(monkeypatch) as logs:
            jax.jit(lambda p, b: rm.loss(p, b))(rp, to_jax(batch))
            with torch.no_grad():
                pm.loss(pp, to_torch(batch))
            jax.effects_barrier()
        assert check_routing(*logs, rp, pp, cfg, f"{arch} loss") == \
            cfg.n_layers
    (want_loss, want), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: rm.loss(p, b), has_aux=True))(rp, to_jax(batch))
    loss, got, grads = port_grads(pm, pp, batch)
    assert set(got) == set(want)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    close_trees(convert.model_params_to_jax(cfg, grads),
                jax.tree.map(np.asarray, ref_grads), what=f"{arch} grad")
