"""llama3.2-1b's training options in the port against the reference, on
the CPU: microbatch 2 and int8 compression with error feedback (both
with ``remat="dots"``, the smoke config's weights and batches of
``tests/test_torch_train_steps.py``, its tolerance), and a checkpoint
written by the reference's trainer (``repro.launch.train``) that the
port's trainer resumes, its later steps equal to the reference's.
"""
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.checkpoint import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.launch.train import main as ref_train_main  # noqa: E402
from repro.train import compression as rcomp  # noqa: E402
from repro.train import optim as roptim  # noqa: E402
from repro.train.train_step import TrainState as RefState  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import make_train_step, param_tree  # noqa: E402

from .test_torch_train_families import (RTOL, batch_np,  # noqa: E402
                                        close_trees, dots_pair, to_torch)
from .test_torch_train_steps import OPT, close_states, run_both  # noqa: E402


def test_llama_microbatch_matches_reference():
    rs, ps, cfg = run_both("llama3.2-1b", microbatch=2)
    close_states(ps, rs, cfg, "microbatch 2")


def test_llama_compressed_steps_match_reference():
    """2 steps with int8 error-feedback compression.  Against the
    reference's run: loss, lr and grad_norm at the tolerance (run_both).
    The state, as ``tests/test_torch_train.py`` holds zamba2's: the port's
    step against the reference's ``ef_compress_grads`` and
    ``adamw_update`` applied to the port's own gradients, residual
    included (int8 rounding turns float32 noise in a gradient near a
    rounding tie into a whole quantization step: one moment of 8,192
    moved by one such step in the reference's own run)."""
    run_both("llama3.2-1b", compress_grads=True)
    _, rp, pm, _ = dots_pair("llama3.2-1b")
    cfg = pm.cfg
    rs = RefState(params=rp, opt=roptim.adamw_init(rp),
                  ef=rcomp.ef_init(rp))
    ps = convert.train_state_from_jax(cfg, jax.tree.map(np.asarray, rs))
    step = make_train_step(pm, optim.AdamWConfig(**OPT), compress_grads=True)
    for i in range(2):
        batch = batch_np(cfg, 1 + i)
        tree = param_tree(ps.params)
        loss, _ = pm.loss(ps.params, to_torch(batch))
        grads = dict(zip(tree, torch.autograd.grad(loss,
                                                   list(tree.values()))))
        before = convert.train_state_to_jax(cfg, ps)
        g_ref, ef_ref = rcomp.ef_compress_grads(
            convert.model_params_to_jax(cfg, grads),
            rcomp.EFState(before.ef.residual))
        p_ref, opt_ref, met = roptim.adamw_update(
            roptim.AdamWConfig(**OPT), before.params, g_ref,
            roptim.OptState(jax.numpy.asarray(before.opt.step),
                            before.opt.mu, before.opt.nu))
        ps, pmet = step(ps, to_torch(batch))
        after = convert.train_state_to_jax(cfg, ps)
        np.testing.assert_allclose(float(pmet["grad_norm"]),
                                   float(met["grad_norm"]), rtol=RTOL)
        close_trees(after.ef.residual, jax.tree.map(np.asarray,
                                                    ef_ref.residual),
                    what="residual")
        close_trees(after.params, jax.tree.map(np.asarray, p_ref),
                    what="params")
        close_trees(after.opt.mu, jax.tree.map(np.asarray, opt_ref.mu),
                    what="mu")
        close_trees(after.opt.nu, jax.tree.map(np.asarray, opt_ref.nu),
                    what="nu")
    assert any(float(t.abs().max()) > 0 for t in ps.ef.residual.values())


def test_llama_resumes_a_reference_checkpoint(tmp_path):
    """The reference trainer runs 4 steps and checkpoints at step 2; the
    port's trainer resumes from that checkpoint and its steps 3-4 equal
    the reference's."""
    arch = "llama3.2-1b"
    flags = ["--arch", arch, "--smoke", "--steps", "4", "--batch", "2",
             "--seq", "32", "--lr", "1e-3", "--ckpt-every", "2",
             "--log-every", "100"]
    want = ref_train_main(flags + ["--ckpt-dir", str(tmp_path / "ref")])
    assert [m["step"] for m in want] == [1, 2, 3, 4]
    ckpt = tmp_path / "port" / arch
    shutil.copytree(tmp_path / "ref" / arch, ckpt)
    ref_mgr = RefCheckpointManager(ckpt)
    assert ref_mgr.steps() == [2, 4]
    shutil.rmtree(ref_mgr.path(4))
    got = train_main(flags + ["--device", "cpu", "--ckpt-dir",
                              str(tmp_path / "port")])
    assert [m["step"] for m in got] == [3, 4]
    for g, w in zip(got, want[2:]):
        for k in ("loss", "nll", "lr", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
