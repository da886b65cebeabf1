"""Deterministic synthetic packed-token data pipeline.

The port's own copy of ``repro.data.synthetic`` (numpy, so the batches are
bitwise the reference's): language-model batches with a learnable
structure (a noisy second-order Markov stream), so training loss measurably
decreases without external data.  The reference's ``device_put_batch``
places a batch into a sharded JAX layout; `to_device` moves one onto an
explicit torch device instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.8      # prob. of following the Markov rule


class SyntheticLM:
    """Iterator of {"tokens", "targets"} batches."""

    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed random bigram successor table: t+1 = table[t] with prob p
        self._table = rng.integers(0, v, size=(v,), dtype=np.int32)
        self._step = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=B)
        follow = rng.random((B, S)) < cfg.structure
        noise = rng.integers(0, v, size=(B, S), dtype=np.int32)
        for t in range(S):
            nxt = self._table[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, noise[:, t])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self):
        return self

    def __next__(self):
        b = self.batch_at(self._step)
        self._step += 1
        return b


def to_device(batch: dict[str, np.ndarray], device) -> dict:
    """A host batch as int32 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device)
            for k, v in batch.items()}
