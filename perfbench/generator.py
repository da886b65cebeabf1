"""The one traffic generator: every mix under ``traffic/`` is parameters
for it.

A ``closed_loop`` mix is ``clients`` callers that each send their next
request when their last one completes (dHTC jobs, each waiting for its
reply).  Request ``i`` of the run belongs to client ``i % clients``.
Lengths are stratified and the same for every seed: the requests are cut
into blocks of ``BLOCK``, and each block holds the same ``BLOCK`` (prompt,
output) pairs: the ``BLOCK`` quantiles of each length distribution, paired
once and for all by a fixed draw, in an order drawn for the block and not
for the seed.  Under a closed loop the order decides which long
admissions meet in one tick, and with it the tail of time to first token
(on one H100 a seed-drawn order moved it between 101 and 198 ms from seed
to seed, against a few percent between two runs of one seed).  Token ids
are uniform over the vocabulary, drawn from the seed and the request
id.

A ``train`` mix has no requests: its batches are `train_batch`.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

BLOCK = 64          # requests a block: each holds every quantile once


def quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the mid-points of ``n`` equal slices of the
    log-normal distribution ``spec`` (``{"dist": "log_normal", "median",
    "sigma", "low", "high"}``: the log of a length is normal about the log
    of ``median``), clipped to the inclusive integer bounds ``low`` and
    ``high``."""
    if spec["dist"] != "log_normal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    out = np.rint(spec["median"] * np.exp(spec["sigma"] * z)).astype(np.int64)
    return np.clip(out, spec["low"], spec["high"])


class ClosedLoop:
    """The requests of one ``closed_loop`` mix under one seed."""

    def __init__(self, mix: dict, seed: int, vocab_size: int):
        if mix["kind"] != "closed_loop":
            raise ValueError(f"mix {mix['name']!r} is not a closed loop")
        self.mix = mix
        self.seed = int(seed)
        self.vocab_size = int(vocab_size)
        self.clients = int(mix["clients"])
        pairing = np.random.default_rng(0x9A1D).permutation(BLOCK)
        self._pairs = list(zip(quantiles(mix["prompt_tokens"], BLOCK),
                               quantiles(mix["output_tokens"], BLOCK)[pairing]))
        self._orders: dict[int, np.ndarray] = {}

    def lengths(self, i: int) -> tuple[int, int]:
        """(prompt tokens, output tokens) of request ``i``."""
        b = i // BLOCK
        if b not in self._orders:
            rng = np.random.default_rng([0x5EED, b])
            self._orders[b] = rng.permutation(BLOCK)
        p, o = self._pairs[self._orders[b][i % BLOCK]]
        return int(p), int(o)

    def request(self, i: int) -> dict:
        """Request ``i`` as a pool entry.  The engine returns its admission
        token plus one per budgeted decode step, so an output of n tokens
        asks for n - 1 new ones."""
        plen, out = self.lengths(i)
        rng = np.random.default_rng([self.seed, i])
        prompt = rng.integers(0, self.vocab_size, size=plen, dtype=np.int64)
        return {"rid": i, "prompt": prompt.tolist(), "max_new_tokens": out - 1}

    def next_of(self, i: int) -> int:
        """The request its client sends after request ``i``."""
        return i + self.clients


def train_batch(seed: int, step: int, batch: int, seq: int,
                vocab_size: int) -> dict:
    """Batch ``step`` of a train run: ``batch`` rows of ``seq + 1``
    uniform token ids from the seed, every row different; tokens and the
    next-token targets, int32, on the host."""
    rng = np.random.default_rng([int(seed), 0x7A1, int(step)])
    toks = rng.integers(0, vocab_size, size=(batch, seq + 1), dtype=np.int64)
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
