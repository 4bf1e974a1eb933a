"""Batched serving driver: a continuous-batching decode loop, in PyTorch.

Mirrors ``repro.launch.serve``.  Prefill builds a request's caches; the
decode loop advances every slot one token per step with greedy or
temperature sampling.  Slot-based continuous batching: a finished
request frees its slot and the next queued prompt is prefilled into it
(cache splice), so the decode batch stays full.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --requests 8 --batch-slots 4 --prompt-len 512 --gen 32 --context 4096

``--arch`` takes every configuration (``configs.list_archs()``).  It runs
on the CUDA device unless ``--device cpu`` is given.  As in the
reference, the command line serves text only: the vlm family's patch
embeds and the encdec family's frames reach a request through
``Server.admit(extras=)``.  An encdec request cannot be served without
its frames, so for that family the command line raises ``ValueError``
(the reference's command line fails there with a ``KeyError``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config, list_archs
from ..models import make_model


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float) -> torch.Tensor:
    """logits (B, V) -> token ids (B,): argmax at temperature 0, else a
    draw from softmax(logits / temperature)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class Server:
    """Slot-based continuous batching around prefill/decode."""

    def __init__(self, model, params, *, slots: int, context: int,
                 temperature: float = 0.0, seed: int = 0):
        self.model = model
        self.params = params
        self.context = context
        self.temperature = temperature
        self.generator = torch.Generator(device=model.device).manual_seed(
            seed)
        self.slots = slots
        self.caches = model.init_caches(slots, context)
        self.tokens = torch.zeros(slots, 1, dtype=torch.int64,
                                  device=model.device)
        self.lengths = np.zeros(slots, np.int64)      # decoded-so-far
        self.active = np.zeros(slots, bool)
        self.outputs = [[] for _ in range(slots)]

    def admit(self, slot: int, prompt: np.ndarray, extras=None):
        """Prefill one prompt and splice its cache into `slot`.
        ``extras``: the request's other inputs without the batch axis
        (the vlm family's "patch_embeds" (n_patches, D), the encdec
        family's "frames" (enc_seq, D)), as arrays or tensors."""
        dev = self.model.device
        batch = {"tokens": torch.as_tensor(np.asarray(prompt)[None],
                                           dtype=torch.int64, device=dev)}
        for k, v in (extras or {}).items():
            batch[k] = torch.as_tensor(v, device=dev)[None]
        logits, cache1 = self.model.prefill(self.params, batch,
                                            context=self.context)
        self.caches = self.model.splice_cache(self.caches, cache1, slot)
        first = sample(logits[:, -1], self.generator, self.temperature)
        self.tokens[slot, 0] = first[0]
        self.lengths[slot] = len(prompt)
        self.active[slot] = True
        self.outputs[slot] = [int(first[0])]

    def step(self):
        """One decode step for every active slot."""
        act = self.active
        if not act.any():
            return
        # positions of retired/empty slots must not move: a stale slot's
        # length would otherwise creep past the write index of the next
        # request spliced into it (and drag the shared decode index with
        # it, clobbering cache rows beyond every live request)
        index = int(self.lengths[act].max())
        logits, self.caches = self.model.decode(self.params, self.tokens,
                                                self.caches, index)
        nxt = sample(logits[:, -1], self.generator, self.temperature)
        self.tokens = nxt[:, None].to(torch.int64)
        self.lengths[act] += 1
        host = nxt.tolist()
        for s in range(self.slots):
            if act[s]:
                self.outputs[s].append(host[s])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels on the host)")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: an encdec request needs its frames ({cfg.enc_seq}, "
            f"{cfg.d_model}), which the command line does not make; serve "
            f"it through Server.admit(slot, prompt, extras={{'frames': "
            f"...}})")
    model = make_model(cfg, device=args.device)
    params = model.init(args.seed)
    rng = np.random.default_rng(args.seed)

    srv = Server(model, params, slots=args.batch_slots,
                 context=args.context, temperature=args.temperature,
                 seed=args.seed)
    pending = [rng.integers(0, cfg.vocab, args.prompt_len)
               for _ in range(args.requests)]
    done = []
    t0 = time.perf_counter()
    gen_tokens = 0
    while pending or srv.active.any():
        for s in range(srv.slots):          # fill free slots
            if not srv.active[s] and pending:
                srv.admit(s, pending.pop())
        srv.step()
        gen_tokens += int(srv.active.sum())
        for s in range(srv.slots):          # retire finished requests
            if srv.active[s] and len(srv.outputs[s]) >= args.gen:
                done.append(srv.outputs[s])
                srv.active[s] = False
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[serve] {len(done)} requests, {gen_tokens} tokens in "
          f"{dt:.2f}s ({gen_tokens / max(dt, 1e-9):.1f} tok/s) on "
          f"{model.device}")
    if len(done) != args.requests:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests")
    return done


if __name__ == "__main__":
    main()
