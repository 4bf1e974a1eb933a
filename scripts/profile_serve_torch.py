#!/usr/bin/env python3
"""Where the time of the port's serving path goes, on one GPU.

    PYTHONPATH=src python3 scripts/profile_serve_torch.py [--arch NAME]
        [--prompt-len N] [--context C]

Builds the config (zamba2-2.7b unless ``--arch`` names another, e.g.
llama3.2-1b) at full width and depth (seeded random weights, bf16
activations) on the CUDA device, warms up, then traces with
torch.profiler (a) one prefill of an N-token prompt (2048 by default)
and (b) 8 decode steps of a Server with 4 active slots at context C
(4096 by default).  Encoder-decoder configs (whisper-small) get seeded
frames with every prompt, through ``Server.admit(extras=)``.  For each window
it prints the wall time (host clock around work that ends in a
synchronise), the device's busy time (the sum of its kernels' and
copies' times; one stream, so they do not overlap), the idle share, the
time by kind (flash-attention kernel, SSD kernel, matrix products,
the f32->bf16 casts, the other copies, the rest) and the ten kernels
with the most device time.  Needs a CUDA
device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


KINDS = (("flash_attention", ("flash_fwd",)),
         ("ssd_intra_chunk", ("ssd_kernel",)),
         ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "gemv")),
         # PyTorch's float->bfloat16 conversion kernel: the per-call
         # casts of the f32 weights (and of any f32 activation)
         ("f32->bf16 casts", ("bfloat16_copy_kernel",)),
         ("other copies", ("copy", "memcpy", "memset")))


def report(what: str, prof, wall_s: float, kinds=KINDS) -> None:
    events = [e for e in prof.key_averages() if device_us(e) > 0]
    busy_us = sum(device_us(e) for e in events
                  if e.device_type is not None and "cuda" in
                  str(e.device_type).lower())
    if busy_us == 0:
        busy_us = sum(device_us(e) for e in events)
    if busy_us == 0:
        print(f"[{what}] the profiler saw no device time")
        return
    print(f"[{what}] wall {wall_s * 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e3 / (wall_s * 1e3):.3f}")
    kernels = [e for e in events if "cuda" in str(e.device_type).lower()]
    seen = set()
    for kind, keys in kinds:
        sel = [e for e in kernels if e.key not in seen
               and any(k in e.key.lower() for k in keys)]
        seen.update(e.key for e in sel)
        t = sum(device_us(e) for e in sel)
        n = sum(e.count for e in sel)
        print(f"[{what}]   {kind}: {t / 1e3:.3f} ms ({t / busy_us:.1%}), "
              f"{n} launches")
    rest = [e for e in kernels if e.key not in seen]
    t = sum(device_us(e) for e in rest)
    print(f"[{what}]   the rest: {t / 1e3:.3f} ms ({t / busy_us:.1%}), "
          f"{sum(e.count for e in rest)} launches")
    for e in sorted(kernels, key=device_us, reverse=True)[:10]:
        print(f"[{what}]     {device_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:160]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--context", type=int, default=4096)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serve_torch: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.models import make_model

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = get_config(args.arch)
    dev = torch.device("cuda")
    model = make_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    n, context = args.prompt_len, args.context

    def extras():
        if cfg.family != "encdec":
            return None
        return {"frames": torch.as_tensor(rng.standard_normal(
            (cfg.enc_seq, cfg.d_model)).astype(np.float32), device=dev)}

    srv = Server(model, params, slots=4, context=context)
    prompt = rng.integers(0, cfg.vocab, n)
    for s in range(4):                               # warm-up, fill slots
        srv.admit(s, rng.integers(0, cfg.vocab, min(512, n)), extras())
    srv.step()
    torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    batch = {"tokens": torch.as_tensor(prompt[None], device=dev)}
    batch.update({k: v[None] for k, v in (extras() or {}).items()})
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        model.prefill(params, batch, context=context)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    report(f"{cfg.name} prefill {n} tokens, {cfg.n_layers} layers", prof,
           wall)

    steps = 8
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            srv.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    report(f"{cfg.name} {steps} decode steps x 4 slots, {cfg.n_layers} "
           f"layers", prof, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
