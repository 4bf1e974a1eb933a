"""Deterministic, shard-aware, resumable data pipeline.

Restart-exactness is the fault-tolerance contract: batch contents are a
pure function of (seed, step, shard), so a job restored from step N
replays step N+1 identically on any number of hosts -- no data-loader
state needs checkpointing beyond the step counter.

The synthetic stream generates Zipf-distributed token ids (a realistic
vocab histogram for an LM) plus next-token labels; per-host sharding
slices the global batch by ``shard/num_shards`` exactly like a
multi-host input pipeline would.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2           # vocab skew
    frames: int = 0               # encdec: frame embeddings per sample
    d_model: int = 0
    n_patches: int = 0            # vlm
    mrope: bool = False


class SyntheticLMStream:
    def __init__(self, cfg: DataConfig, shard: int = 0,
                 num_shards: int = 1, start_step: int = 0):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.step = start_step

    def _rng(self, step: int) -> np.random.Generator:
        # content depends only on (seed, step): restart-exact
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        B, S = cfg.global_batch, cfg.seq_len
        z = rng.zipf(cfg.zipf_a, size=(B, S + 1)).astype(np.int64)
        tokens_full = (z - 1) % cfg.vocab
        batch = {"tokens": tokens_full[:, :S].astype(np.int32),
                 "labels": tokens_full[:, 1:].astype(np.int32)}
        if cfg.frames:
            batch["frames"] = rng.standard_normal(
                (B, cfg.frames, cfg.d_model), np.float32)
        if cfg.n_patches:
            batch["patch_embeds"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model), np.float32)
        if cfg.mrope:
            pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None],
                                  (B, S))
            batch["positions"] = np.repeat(pos[..., None], 3, -1)
        # host shard: contiguous slice of the global batch
        lo = self.shard * (B // self.num_shards)
        hi = lo + B // self.num_shards
        return {k: v[lo:hi] for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b


def make_stream(model_cfg, seq_len: int, global_batch: int, *,
                seed: int = 0, shard: int = 0, num_shards: int = 1,
                start_step: int = 0) -> SyntheticLMStream:
    dc = DataConfig(
        vocab=model_cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed,
        frames=model_cfg.enc_seq if model_cfg.family == "encdec" else 0,
        d_model=model_cfg.d_model,
        n_patches=(model_cfg.n_patches if model_cfg.family == "vlm"
                   else 0),
        mrope=model_cfg.mrope)
    return SyntheticLMStream(dc, shard, num_shards, start_step)
