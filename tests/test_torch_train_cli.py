"""The port's trainer (``python -m repro_torch.launch.train``) on
the CPU, against the reference's (``repro.launch.train``).

- ~60 smoke steps lower the loss by 0.2, as
  ``tests/test_train_substrate.py::test_training_reduces_loss_end_to_end``
  asks of the reference.
- A run killed at step 20 (exit 42) and resumed replays the losses of an
  uninterrupted 30-step run at 1e-5, as
  ``tests/test_fault_tolerance.py::test_crash_restart_resumes_identically``
  asks of the reference.
- From the reference's own initial state (its step-0 checkpoint, which
  the port's trainer restores: both write the reference's layout), the
  port's per-step losses equal the reference trainer's with the same
  flags at 1e-4.
- Serving is unchanged by the training code: with the launchers stubbed
  as the card would run them, a prefill launches each kernel as often as
  before, never asks for the log-sum-exp and records no graph; a
  training step asks for it on every attention launch.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.checkpoint import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch.train import main as ref_train_main  # noqa: E402
from repro.models import make_model as ref_make  # noqa: E402
from repro.train import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.train.train_step import train_state_init as ref_state_init  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fo  # noqa: E402
from repro_torch.kernels.mamba2_scan import ops as so  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import make_model  # noqa: E402

ARCH = "zamba2-2.7b"
ROOT = Path(__file__).resolve().parents[1]


def _flags(tmp, name, steps, *extra):
    return ["--arch", ARCH, "--smoke", "--steps", str(steps), "--batch", "4",
            "--seq", "64", "--ckpt-dir", str(tmp / name), "--log-every",
            "100", *extra]


def test_training_reduces_loss_end_to_end(tmp_path):
    hist = train_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "60", "--batch", "8", "--seq", "64",
                       "--lr", "1e-3", "--ckpt-dir", str(tmp_path / "ck"),
                       "--log-every", "60"])
    assert len(hist) == 60
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.2


def test_crash_restart_resumes_identically(tmp_path):
    """Killed after step 20 in a process of its own, restarted: steps
    21-30 equal the uninterrupted run's losses at 1e-5."""
    base = _flags(tmp_path, "ck", 30, "--device", "cpu", "--ckpt-every",
                  "10")
    ref = train_main(_flags(tmp_path, "ref_ck", 30, "--device", "cpu",
                            "--ckpt-every", "10"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *base, "--simulate-failure", "20"], env=env,
                       cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 42, r.stdout + r.stderr
    assert "simulated failure" in r.stdout
    out = tmp_path / "resumed.json"
    got = train_main(base + ["--metrics-out", str(out)])
    assert [m["step"] for m in got] == list(range(21, 31))
    assert json.loads(out.read_text()) == got
    by_step = {m["step"]: m["loss"] for m in ref}
    for m in got:
        np.testing.assert_allclose(m["loss"], by_step[m["step"]], rtol=1e-5)


def test_losses_match_the_reference_trainer(tmp_path):
    """Both trainers resume from the reference's step-0 state (same
    weights, zero moments) and train 6 steps on the same data."""
    rm = ref_make(ref_smoke(ARCH))
    state, _ = ref_state_init(rm, jax.random.key(0),
                              RefAdamWConfig(lr=1e-3))
    RefCheckpointManager(tmp_path / "init" / ARCH, keep_n=2).save(
        state, 0, block=True)
    shutil.copytree(tmp_path / "init", tmp_path / "port")
    shutil.copytree(tmp_path / "init", tmp_path / "ref")
    extra = ("--lr", "1e-3", "--ckpt-every", "3")
    want = ref_train_main(_flags(tmp_path, "ref", 6, *extra))
    got = train_main(_flags(tmp_path, "port", 6, "--device", "cpu", *extra))
    assert [m["step"] for m in got] == [m["step"] for m in want] == \
        list(range(1, 7))
    for g, w in zip(got, want):
        for k in ("loss", "nll", "lr", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    # the port's last checkpoint is one the reference's manager reads
    _, at = RefCheckpointManager(tmp_path / "port" / ARCH).restore_latest(
        state)
    assert at == 6


def _stub_launchers(monkeypatch, calls):
    """The card's dispatch on CPU tensors: the launchers stubbed by the
    plain versions, each launch recorded (and counted, as the real
    launchers count)."""
    def flash(q, k, v, causal, window, *, lse=False, out=None, rows=None,
              out32=None):
        calls.append(("flash", lse))
        fo.attention.launches += 1
        o = fo.attention_plain(q, k, v, causal=causal, window=window)
        return o, (torch.zeros(q.shape[0], q.shape[2], q.shape[1])
                   if lse else None), None

    def flash_bwd(q, k, v, dout, lse, causal, window, *, out32=None,
                  grads=None):
        calls.append(("flash_bwd", lse is not None))
        fo.attention_bwd.launches += 2
        return fo.attention_bwd_ref(q, k, v, dout, causal=causal,
                                    window=window)

    def ssd(*args, out=None):
        calls.append(("ssd", None))
        so.ssd_intra_chunk.launches += 1
        return so.intra_chunk_ref(*args)

    def ssd_bwd(*args, grads=None):
        calls.append(("ssd_bwd", None))
        so.ssd_intra_chunk_bwd.launches += 1
        return so.intra_chunk_bwd_ref(*args)

    for mod in (fo, so):
        monkeypatch.setattr(mod, "_on_card", lambda t: True)
    monkeypatch.setattr(fo, "_launch", flash)
    monkeypatch.setattr(fo, "_launch_bwd", flash_bwd)
    monkeypatch.setattr(so, "_launch", ssd)
    monkeypatch.setattr(so, "_launch_bwd", ssd_bwd)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_serving_is_unchanged_and_training_asks_for_lse(monkeypatch, remat):
    cfg = get_smoke_config(ARCH).replace(remat=remat)
    model = make_model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)))
    plain_logits, _ = model.prefill(params, {"tokens": toks}, context=128)
    calls = []
    _stub_launchers(monkeypatch, calls)
    G = cfg.n_layers // cfg.shared_attn_every
    logits, caches = model.prefill(params, {"tokens": toks}, context=128)
    assert torch.equal(logits, plain_logits)
    assert logits.grad_fn is None and not logits.requires_grad
    assert calls.count(("flash", False)) == G
    assert len([c for c in calls if c[0] == "flash"]) == G
    assert calls.count(("ssd", None)) == cfg.n_layers
    # a training step: every attention launch keeps its lse, every
    # forward runs twice under remat "full", and each backward launches
    calls.clear()
    params.requires_grad_(True)
    loss, _ = model.loss(params, {"tokens": toks, "labels": toks})
    loss.backward()
    runs = 2 if remat == "full" else 1
    assert calls.count(("flash", True)) == G * runs
    assert calls.count(("flash", False)) == 0
    assert calls.count(("ssd", None)) == cfg.n_layers * runs
    assert calls.count(("flash_bwd", True)) == G
    assert calls.count(("ssd_bwd", None)) == cfg.n_layers
