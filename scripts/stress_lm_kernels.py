#!/usr/bin/env python3
"""Repeat the port's flash-attention and intra-chunk SSD kernels over
many inputs on one GPU, holding every launch to a float64 oracle.

    PYTHONPATH=src python3 scripts/stress_lm_kernels.py

A kernel that reads shared memory before it is written, or races
between threads, gives wrong values only now and then.  This script
launches each kernel many times, on the serving path's shapes, on the
card tests' shapes and on seeded random ones, and checks every launch:

- a second launch on the same inputs gives the same bits;
- every output element lies within a first-order float32 rounding
  bound of the float64 result (``ssd_error_bound``,
  ``flash_error_bound``), times 2.  The bound holds for any order of
  the sums, so it needs no knowledge of the kernel's order, and a
  missing, stale or doubled term exceeds it by orders of magnitude.

For comparison it also counts, on the same inputs, the elements where
the plain PyTorch version on the card (TF32 off) leaves the same bound,
and, for the SSD case of ``tests/test_torch_cuda.py`` that once failed,
compares the kernel with the plain version on the host at that test's
2e-5.  The backward kernels (``backward_groups``) are held to their
float64 plain backward at the card checks' tolerances, and repeated,
half of the repeats after every SM's shared memory is filled with NaN;
the flash backward's launches are counted by route (bf16 with head_dim
a multiple of 8 on the tensor cores, the rest on the FMA kernels).
Prints one line per group and a JSON summary last; exits 1 if a
kernel launch leaves its bound or repeats differently.  A few minutes
on an H100.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

U = 2.0 ** -24          # unit roundoff of float32
FLASH_TILE = 64         # k-tile of csrc/flash_attention.cu
SAFETY = 2.0            # margin over the first-order bound


def ssd_error_bound(x, dt, cum, Bm, Cm):
    """(y in float64, bound on |y_f32 - y|) for the intra-chunk SSD.

    Any float32 evaluation that forms C_i.B_j as an N-term sum, the
    score as its product with exp(cum_i - cum_j) (the difference rounded
    once) and dt_j, and y as an L-term sum, lies within this of the
    exact result, to first order in the unit roundoff.
    """
    x, dt, cum, Bm, Cm = (t.double() for t in (x, dt, cum, Bm, Cm))
    L, N = x.shape[1], Bm.shape[-1]
    diff = cum[:, :, None, :] - cum[:, None, :, :]               # g i j h
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    w = torch.where(mask[None, :, :, None], torch.exp(diff), 0.0) \
        * dt[:, None, :, :]                                       # >= 0
    cb = torch.einsum("gin,gjn->gij", Cm, Bm)[..., None]
    cb_abs = torch.einsum("gin,gjn->gij", Cm.abs(), Bm.abs())[..., None]
    y = torch.einsum("gijh,gjhp->gihp", w * cb, x)
    per_term = w * ((N + 2) * U * cb_abs
                    + cb.abs() * U * (diff.abs() + 8 + L + 2))
    return y, torch.einsum("gijh,gjhp->gihp", per_term, x.abs())


def flash_error_bound(q, k, v, causal, window):
    """(o in float64, bound on |o_f32 - o|) for attention in the model's
    layout, q (B, S, H, hd) and k/v (B, T, KV, hd).

    Covers an online softmax in float32 over k-tiles of FLASH_TILE: the
    hd-term score sums, the subtraction of the running max, exp, one
    rescale of the accumulator and denominator per tile, and T-term sums
    of p and p*v, to first order in the unit roundoff.  The output's
    rounding to q's type is not included.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    n_tiles = -(-T // FLASH_TILE)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(T, device=q.device)[None, :]
    band = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        band &= kj <= qi
    if window is not None:
        band &= (qi - kj) < window
    o = torch.zeros(B, S, H, hd, dtype=torch.float64, device=q.device)
    err = torch.zeros_like(o)
    for b in range(B):
        for h in range(H):
            qh = q[b, :, h].double()
            kh, vh = (t[b, :, h // (H // KV)].double() for t in (k, v))
            s = torch.where(band, qh @ kh.T * scale, -math.inf)
            s_abs = qh.abs() @ kh.abs().T * scale
            m = s.max(-1, keepdim=True).values
            p = torch.exp(s - m)
            wgt = p / p.sum(-1, keepdim=True)
            ob = wgt @ vh
            r = torch.where(band, (hd + 2) * U * s_abs + U * (s - m).abs(),
                            0.0)
            r = r + U * (4 + 2 * n_tiles + 2 * s_abs.amax(-1, keepdim=True))
            wr = wgt * r
            o_abs = ob.abs()
            err[b, :, h] = (wr @ vh.abs() + o_abs * wr.sum(-1, keepdim=True)
                            + (T + 3) * U * (wgt @ vh.abs() + o_abs))
            o[b, :, h] = ob
    return o, err


def over_bound(got, want, err, out_dtype) -> torch.Tensor:
    """Mask of the elements of ``got`` outside SAFETY x the bound, plus
    the rounding of the result to ``out_dtype`` (half a step, at most
    2^-8 of the value in bfloat16)."""
    tol = SAFETY * err
    if out_dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * (want.abs() + tol)
    return (got.double() - want).abs() > tol


def ratio(got, want, err) -> float:
    """Largest |got - want| over SAFETY x bound (float32 outputs)."""
    return float(((got.double() - want).abs()
                  / (SAFETY * err).clamp_min(1e-300)).max())


def ssd_inputs(gen, dev, G, L, H, P, N):
    sp = torch.nn.functional.softplus
    x = torch.randn(G, L, H, P, device=dev, generator=gen)
    dt = sp(torch.randn(G, L, H, device=dev, generator=gen))
    cum = torch.cumsum(-sp(torch.randn(G, L, H, device=dev, generator=gen)),
                       dim=1)
    Bm, Cm = (torch.randn(G, L, N, device=dev, generator=gen) for _ in "BC")
    return x, dt, cum, Bm, Cm


def backward_groups(dev, rng, summary, faults) -> None:
    """The backward kernels: every launch repeats bit for bit (half of
    them after every SM's shared memory is filled with NaN) and lies
    within rtol = atol = 1e-4 (bf16: 2e-2) of the float64 plain
    backward; the float32 plain backward on the card is counted against
    the same bound."""
    from repro_torch.kernels.common import poison_shared_memory
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.kernels.mamba2_scan import ops as so
    from repro_torch.kernels.mamba2_scan.ref import intra_chunk_bwd_ref

    def outside(got, exact, tol):
        return sum(int((~torch.isclose(g.double(), e, rtol=tol, atol=tol))
                       .sum()) for g, e in zip(got, exact))

    def group(name, cases, run, plain, repeats, route=None):
        launches = bad = plain_bad = 0
        routes = {}
        for i, (args, tol) in enumerate(cases):
            exact = plain(*(None if a is None else a.double() for a in args))
            got = run(*args)
            launches += 1
            if route is not None:
                routes[route()] = routes.get(route(), 0) + 1 + repeats
            n_bad = outside(got, exact, tol)
            for r in range(repeats):
                if (i + r) % 2:
                    poison_shared_memory(dev)
                again = run(*args)
                launches += 1
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    faults.append(f"{name} case {i}: a repeat differs")
            plain_bad += outside(plain(*args), exact, tol)
            if n_bad:
                faults.append(f"{name} case {i}: {n_bad} elements outside")
            bad += n_bad
        torch.cuda.synchronize()
        summary[name] = {"cases": len(cases), "launches": launches,
                         "kernel_elements_outside": bad,
                         "plain_on_card_elements_outside": plain_bad}
        if route is not None:
            summary[name]["launches_by_route"] = routes
        print(f"[{name}] {len(cases)} cases, {launches} launches"
              + (f" (by route {routes})" if route is not None else "")
              + f", {bad} elements outside the bound; plain version on the "
              f"card: {plain_bad} outside")

    def ssd_case(G, L, H, P, N, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x, dt, cum, Bm, Cm = ssd_inputs(gen, dev, G, L, H, P, N)
        dy = torch.randn(G, L, H, P, device=dev, generator=gen)
        return (x, dt, cum, Bm, Cm, dy), 1e-4

    ssd = [ssd_case(128, 64, 80, 64, 64, s) for s in range(4)]
    ssd += [ssd_case(int(rng.integers(1, 9)), int(rng.integers(1, 65)),
                     int(rng.integers(1, 33)), int(rng.integers(1, 129)),
                     int(rng.integers(1, 129)), 3000 + i)
            for i in range(200)]
    group("ssd backward", ssd, so._launch_bwd, intra_chunk_bwd_ref,
          repeats=2)

    def flash_case(B, S, H, KV, hd, dtype, causal, window, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, do = (torch.randn(B, S, H, hd, device=dev, generator=gen)
                 .to(dtype) for _ in "qo")
        k, v = (torch.randn(B, S, KV, hd, device=dev, generator=gen)
                .to(dtype) for _ in "kv")
        _, lse, o32 = fo._launch(q, k, v, causal, window, lse=True)
        return (q, k, v, do, lse, o32, causal, window), (
            2e-2 if dtype == torch.bfloat16 else 1e-4)

    bf16, f32 = torch.bfloat16, torch.float32
    flash = [flash_case(1, 1024, 8, 8, 80, bf16, True, None, s)
             for s in range(4)]
    flash += [flash_case(1, 2048, 32, 32, 80, bf16, True, None, 10 + s)
              for s in range(2)]
    # the tensor-core route: bf16, head_dim a multiple of 8
    for i in range(60):
        KV = int(rng.choice([1, 2, 4]))
        causal = bool(rng.integers(0, 2))
        flash.append(flash_case(
            int(rng.integers(1, 3)), int(rng.integers(1, 400)),
            KV * int(rng.choice([1, 2])), KV, 8 * int(rng.integers(1, 17)),
            bf16, causal, int(rng.integers(1, 200)) if causal
            and rng.random() < 0.5 else None, 5000 + i))
    for i in range(120):
        KV = int(rng.choice([1, 2, 4]))
        causal = bool(rng.integers(0, 2))
        flash.append(flash_case(
            1, int(rng.integers(1, 300)), KV * int(rng.choice([1, 2])), KV,
            int(rng.integers(1, 129)), bf16 if rng.random() < 0.3 else f32,
            causal, int(rng.integers(1, 100)) if causal and rng.random() < 0.5
            else None, 4000 + i))

    group("flash backward", [((q, k, v, do, lse, o32), tol) for
                             (q, k, v, do, lse, o32, c, w), tol in flash
                             if c and w is None],
          lambda q, k, v, do, lse, o32: fo._launch_bwd(
              q, k, v, do, lse, True, None, out32=o32),
          lambda q, k, v, do, lse, o32: attention_bwd_ref(q, k, v, do),
          repeats=2, route=fo.last_bwd_route)
    group("flash backward, other masks",
          [((q, k, v, do, lse, o32, torch.tensor([int(c), w or 0])), tol)
           for (q, k, v, do, lse, o32, c, w), tol in flash
           if not (c and w is None)],
          lambda q, k, v, do, lse, o32, m: fo._launch_bwd(
              q, k, v, do, lse, bool(m[0]), int(m[1]) or None, out32=o32),
          lambda q, k, v, do, lse, o32, m: attention_bwd_ref(
              q, k, v, do, causal=bool(m[0]), window=int(m[1]) or None),
          repeats=2, route=fo.last_bwd_route)


def main() -> int:
    if not torch.cuda.is_available():
        print("stress_lm_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref, expand_kv
    from repro_torch.kernels.mamba2_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.mamba2_scan.ref import intra_chunk_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rng = np.random.default_rng(0)
    summary, faults = {}, []
    t0 = time.perf_counter()

    # ---- SSD -------------------------------------------------------------
    def ssd_group(name, cases, repeats):
        """cases: (G, L, H, P, N, generator seed); each launched
        1 + repeats times."""
        launches = bad = plain_bad = worst = 0
        for G, L, H, P, N, seed in cases:
            gen = torch.Generator(device=dev).manual_seed(seed)
            args = ssd_inputs(gen, dev, G, L, H, P, N)
            want, err = ssd_error_bound(*args)
            y = ssd_intra_chunk(*args)
            launches += 1
            n_bad = int(over_bound(y, want, err, torch.float32).sum())
            worst = max(worst, ratio(y, want, err))
            for _ in range(repeats):
                y2 = ssd_intra_chunk(*args)
                launches += 1
                if not torch.equal(y, y2):
                    n_bad += int(over_bound(y2, want, err,
                                            torch.float32).sum())
                    faults.append(f"ssd {name} {(G, L, H, P, N)} seed {seed}:"
                                  f" a repeat differs")
            plain = intra_chunk_ref(*args)
            plain_bad += int(over_bound(plain, want, err,
                                        torch.float32).sum())
            if n_bad:
                faults.append(f"ssd {name} {(G, L, H, P, N)} seed {seed}: "
                              f"{n_bad} elements outside the bound")
            bad += n_bad
        torch.cuda.synchronize()
        summary[f"ssd {name}"] = {"cases": len(cases), "launches": launches,
                                  "kernel_elements_outside": bad,
                                  "worst_err_over_bound": worst,
                                  "plain_on_card_elements_outside":
                                      plain_bad}
        print(f"[ssd] {name}: {len(cases)} cases, {launches} launches, "
              f"{bad} elements outside the bound (worst error "
              f"{worst:.3g} of it); plain version on the card: {plain_bad} "
              f"outside")

    # the card test's case that failed once, as that test makes it
    G, L, H, P, N = 6, 64, 8, 64, 64
    ssd_group("card-test case", [(G, L, H, P, N, G * L)], repeats=4999)
    gen = torch.Generator(device=dev).manual_seed(G * L)
    args = ssd_inputs(gen, dev, G, L, H, P, N)
    host = intra_chunk_ref(*(t.cpu() for t in args))
    n_host, n_launch = 0, 1000
    for _ in range(n_launch):
        y = ssd_intra_chunk(*args).cpu()
        n_host += int((~torch.isclose(y, host, rtol=2e-5, atol=2e-5)).sum())
    summary["ssd card-test case vs host plain at 2e-5"] = {
        "launches": n_launch, "elements_outside": n_host}
    print(f"[ssd] card-test case against the host's plain version at 2e-5, "
          f"{n_launch} launches: {n_host} elements outside")
    if n_host:
        faults.append(f"ssd card-test case: {n_host} elements off the host")

    ssd_group("main shape (G=32, L=64, H=80, P=64, N=64)",
              [(32, 64, 80, 64, 64, s) for s in range(20)], repeats=49)
    rand = [(int(rng.integers(1, 41)), int(rng.integers(1, 65)),
             int(rng.integers(1, 97)), int(rng.integers(1, 129)),
             int(rng.integers(1, 129)), 1000 + i) for i in range(1500)]
    ssd_group("random shapes", rand, repeats=1)

    # ---- flash attention ---------------------------------------------------
    def flash_group(name, cases, repeats):
        """cases: (B, S, T, H, KV, hd, dtype, causal, window, seed)."""
        launches = bad = plain_bad = 0
        worst = 0.0
        for B, S, T, H, KV, hd, dtype, causal, window, seed in cases:
            gen = torch.Generator(device=dev).manual_seed(seed)
            q, k, v = (torch.randn(B, n, h, hd, device=dev,
                                   generator=gen).to(dtype)
                       for n, h in ((S, H), (T, KV), (T, KV)))
            want, err = flash_error_bound(q, k, v, causal, window)
            o = attention(q, k, v, causal=causal, window=window)
            launches += 1
            n_bad = int(over_bound(o, want, err, dtype).sum())
            if dtype == torch.float32:
                worst = max(worst, ratio(o, want, err))
            for _ in range(repeats):
                o2 = attention(q, k, v, causal=causal, window=window)
                launches += 1
                if not torch.equal(o, o2):
                    n_bad += int(over_bound(o2, want, err, dtype).sum())
                    faults.append(f"flash {name} seed {seed}: a repeat "
                                  f"differs")
            plain = attention_ref(q.transpose(1, 2), expand_kv(k, H),
                                  expand_kv(v, H), causal=causal,
                                  window=window).transpose(1, 2)
            plain_bad += int(over_bound(plain, want, err, dtype).sum())
            if n_bad:
                faults.append(f"flash {name} {(B, S, T, H, KV, hd)} "
                              f"{dtype} causal={causal} window={window} "
                              f"seed {seed}: {n_bad} elements outside")
            bad += n_bad
        torch.cuda.synchronize()
        summary[f"flash {name}"] = {"cases": len(cases), "launches": launches,
                                    "kernel_elements_outside": bad,
                                    "worst_f32_err_over_bound": worst,
                                    "plain_on_card_elements_outside":
                                        plain_bad}
        print(f"[flash] {name}: {len(cases)} cases, {launches} launches, "
              f"{bad} elements outside the bound (worst f32 error "
              f"{worst:.3g} of it); plain version on the card: {plain_bad} "
              f"outside")

    bf16, f32 = torch.bfloat16, torch.float32
    flash_group("serving shapes", [
        (1, 2048, 2048, 32, 32, 80, bf16, True, None, 0),
        (1, 1781, 1781, 32, 32, 80, bf16, True, None, 1),
        (1, 2048, 2048, 32, 32, 16, f32, True, None, 2),
        (1, 2048, 2048, 32, 32, 128, f32, True, None, 3),
        (1, 1000, 1000, 32, 32, 80, f32, True, None, 4),
        (1, 2048, 2048, 32, 32, 80, f32, False, None, 5),
        (1, 2048, 2048, 32, 32, 80, f32, True, 512, 6),
        (1, 2048, 2048, 32, 8, 80, bf16, True, None, 7),
    ], repeats=49)
    cases = []
    for i in range(1000):
        KV = int(rng.choice([1, 2, 4]))
        H = KV * int(rng.choice([1, 2, 4]))
        causal = bool(rng.integers(0, 2))
        S = int(rng.integers(1, 400))
        T = S if causal else int(rng.integers(1, 400))
        # a window only with the causal mask: every row keeps a key
        window = (int(rng.integers(1, 200))
                  if causal and rng.random() < 0.5 else None)
        cases.append((int(rng.integers(1, 3)), S, T, H, KV,
                      int(rng.integers(1, 129)),
                      bf16 if rng.random() < 0.4 else f32, causal, window,
                      2000 + i))
    flash_group("random shapes", cases, repeats=1)

    backward_groups(dev, rng, summary, faults)

    summary["seconds"] = time.perf_counter() - t0
    summary["faults"] = faults[:20]
    for f in faults[:20]:
        print(f"[fault] {f}")
    print(json.dumps(summary))
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
