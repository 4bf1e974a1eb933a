"""End-to-end training entry point, in PyTorch.

Mirrors ``repro.launch.train``: the same flags, the same restart-exact
data (batch = f(seed, step)), checkpoint and restore (atomic, async,
the two newest kept), straggler detection on step-time telemetry, and
``--simulate-failure`` to kill the process (exit 42) at a step so that
tests exercise the restart path.  Every family of the reference trains:
the hybrid (zamba2), the decoder-only transformers (dense, MoE, and VLM
with the batch's seeded patch embeds and M-RoPE positions), the
encoder-decoder (whisper, with the batch's seeded frames) and the xLSTM;
each batch entry goes to the model's device.  One device: the CUDA
device unless ``--device cpu`` is given.  Checkpoints are written in the
reference's layout (``convert.train_state_to_jax``), so either package
resumes from the other's.  ``--ckpt-every 0`` writes none (the reference
has no such setting: its modulo by 0 raises); the debug mesh and the
sharding rules of the reference wait for the LM sharding rules
(ROADMAP.md).

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
      --smoke --device cpu --steps 50 --batch 8 --seq 128

(any of ``configs.list_archs()`` for ``--arch``).
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch

from .. import convert
from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import make_stream
from ..models import make_model
from ..runtime import StragglerDetector
from ..train import AdamWConfig, make_train_step, train_state_init


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) /
                                "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25,
                    help="save every N steps and at the end; 0 saves none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="crash (exit 42) after this step, for restart tests")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device for any family (default: cuda; "
                         "'cpu' runs the plain versions of the kernels on "
                         "the host)")
    return ap.parse_args(argv)


def main(argv=None, *, return_state=False):
    """Train; returns the history (one dict of metrics a step), and the
    final train state too with ``return_state``."""
    args = parse_args(argv)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    model = make_model(cfg, device=args.device)
    dev = model.device
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 5))
    step_fn = make_train_step(model, opt,
                              microbatch=args.microbatch or None,
                              compress_grads=args.compress_grads)
    mgr = CheckpointManager(Path(args.ckpt_dir) / args.arch, keep_n=2)

    state = train_state_init(
        model, torch.Generator(device=dev).manual_seed(args.seed), opt,
        compress=args.compress_grads)
    start_step = 0
    if mgr.latest_step() is not None:
        restored, at = mgr.restore_latest(
            convert.train_state_to_jax(cfg, state))
        state, start_step = convert.train_state_from_jax(
            cfg, restored, into=state), int(at)
        print(f"[train] restored checkpoint at step {start_step}")

    stream = make_stream(cfg, args.seq, args.batch, seed=args.seed,
                         start_step=start_step)
    detector = StragglerDetector(["host0"])
    history = []
    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in stream.batch_at(step).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        detector.step({"host0": dt})
        history.append({"step": step + 1, **metrics, "time_s": dt})
        if (step + 1) % args.log_every == 0 or step == start_step:
            print(f"[train] step {step+1:5d} loss {metrics['loss']:.4f} "
                  f"nll {metrics['nll']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} {dt*1e3:.0f} ms",
                  flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            mgr.save(convert.train_state_to_jax(cfg, state), step + 1,
                     block=False)
        if args.simulate_failure and step + 1 == args.simulate_failure:
            mgr.wait()      # the restart resumes from this step's save
            print("[train] simulated failure", flush=True)
            raise SystemExit(42)
    mgr.wait()
    if args.ckpt_every:
        mgr.save(convert.train_state_to_jax(cfg, state), args.steps,
                 block=True)
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(history))
    if history:
        first, last = history[0], history[-1]
        print(f"[train] done: loss {first['loss']:.4f} -> "
              f"{last['loss']:.4f} over {len(history)} steps")
    return (history, state) if return_state else history


if __name__ == "__main__":
    main()
