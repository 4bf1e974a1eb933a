#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one GPU.

    PYTHONPATH=src python3 scripts/profile_train_torch.py [--arch NAME]
        [--batch 2] [--seq 4096]

Builds the config (zamba2-2.7b unless ``--arch`` names another, e.g.
llama3.2-1b) at full width and depth (seeded random weights, bf16
activations, f32 parameters and AdamW moments, the config's remat) on
the CUDA device, runs one warm-up step of ``train_step.make_train_step``
on the trainer's seeded batches (with the family's frames, patch embeds
and positions), then traces one step with torch.profiler and prints, as
``scripts/profile_serve_torch.py`` does for serving, the wall time, the
device's busy time and idle share, the time by kind (the two LM kernels
and their backward kernels, matrix products, the f32->bf16 casts, the
other copies, the rest) and the ten kernels with the most device time.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from profile_serve_torch import report  # noqa: E402

KINDS = (("flash_attention_bwd", ("flash_bwd_dq", "flash_bwd_dkdv")),
         ("flash_attention", ("flash_fwd",)),
         ("ssd_intra_chunk_bwd", ("ssd_bwd_kernel",)),
         ("ssd_intra_chunk", ("ssd_kernel",)),
         ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "gemv")),
         ("f32->bf16 casts", ("bfloat16_copy_kernel",)),
         ("other copies", ("copy", "memcpy", "memset")))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_torch: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data import make_stream
    from repro_torch.models import make_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train import train_state_init

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = get_config(args.arch)
    dev = torch.device("cuda")
    model = make_model(cfg, device=dev)
    opt = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    state = train_state_init(model, torch.Generator(device=dev).manual_seed(0),
                             opt)
    step = make_train_step(model, opt)
    stream = make_stream(cfg, args.seq, args.batch, seed=0)

    def batch(i):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in stream.batch_at(i).items()}

    state, _ = step(state, batch(0))                 # warm-up
    torch.cuda.synchronize()
    b = batch(1)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    report(f"{cfg.name} train step {args.batch} x {args.seq} tokens, "
           f"{cfg.n_layers} layers, remat {cfg.remat}, loss "
           f"{float(met['loss']):.4f}", prof, wall, KINDS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
