"""AdamW steps of every non-hybrid family in the port against the
reference's jitted ``make_train_step``, on the CPU.

The nine smoke configs with ``remat="dots"`` in both packages, float32,
from the same weights and batches as ``tests/test_torch_train_families
.py`` (the reference's perturbed leaves, zero moments, step 0, carried
across by ``convert.train_state_from_jax``).  After two steps every
parameter, both moments, the step and the metrics agree at rtol 2e-4 /
atol 2e-6 with AdamW eps 1e-3 (see OPT in ``tests/test_torch_train.py``:
the default eps turns a gradient's float32 noise near zero into a whole
learning-rate step).  llama3.2-1b's microbatches, compression and
checkpoints are ``tests/test_torch_train_llama.py``'s.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.train import compression as rcomp  # noqa: E402
from repro.train import optim as roptim  # noqa: E402
from repro.train.train_step import TrainState as RefState  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

from .test_torch_train_families import (ARCHS, ATOL, RTOL,  # noqa: E402
                                        batch_np, close_trees, dots_pair,
                                        to_jax, to_torch)

OPT = dict(lr=1e-3, warmup_steps=0, schedule="constant", eps=1e-3)


def run_both(arch, steps=2, **kw):
    """(reference state, port state, config) after ``steps`` steps of
    both packages' train steps with the keywords ``kw`` (microbatch,
    compress_grads), each step's metrics compared on the way."""
    rm, rp, pm, _ = dots_pair(arch)
    cfg = pm.cfg
    compress = kw.get("compress_grads", False)
    rs = RefState(params=rp, opt=roptim.adamw_init(rp),
                  ef=rcomp.ef_init(rp) if compress else None)
    ps = convert.train_state_from_jax(cfg, jax.tree.map(np.asarray, rs))
    ref_step = jax.jit(ref_make_step(rm, roptim.AdamWConfig(**OPT), **kw))
    step = make_train_step(pm, optim.AdamWConfig(**OPT), **kw)
    for i in range(steps):
        batch = batch_np(cfg, 1 + i, B=4 if kw.get("microbatch") else 2)
        rs, rmet = ref_step(rs, to_jax(batch))
        ps, pmet = step(ps, to_torch(batch))
        assert set(pmet) == set(rmet)
        for k in ("lr", "grad_norm", "loss", "nll", "aux"):
            np.testing.assert_allclose(float(pmet[k]), float(rmet[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i + 1} {k}")
    return rs, ps, cfg


def close_states(ps, rs, cfg, what):
    got = convert.train_state_to_jax(cfg, ps)
    want = jax.tree.map(np.asarray, rs)
    assert int(got.opt.step) == int(want.opt.step)
    close_trees(got.params, want.params, what=f"{what} params")
    close_trees(got.opt.mu, want.opt.mu, what=f"{what} mu")
    close_trees(got.opt.nu, want.opt.nu, what=f"{what} nu")
    if want.ef is not None:
        close_trees(got.ef.residual, want.ef.residual,
                    what=f"{what} residual")


@pytest.mark.parametrize("arch", ARCHS)
def test_two_adamw_steps_match_reference(arch):
    rs, ps, cfg = run_both(arch)
    assert int(ps.opt.step) == 2
    close_states(ps, rs, cfg, arch)
