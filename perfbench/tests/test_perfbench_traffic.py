"""The mixes: deterministic from the seed, inside their stated ranges,
and the same sizes in the same order for every seed, block by block; only
the token ids follow the seed."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from perfbench.generator import BLOCK, ClosedLoop, train_batch

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))
SEEDS = [0, 7, 2 ** 31 + 11, 3 * 2 ** 40]


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(n for n in MIXES if n != "train"))
def test_deterministic_and_in_range(name):
    mix = _mix(name)
    a, b = ClosedLoop(mix, 2 ** 33 + 5, 49155), ClosedLoop(mix, 2 ** 33 + 5, 49155)
    for i in range(0, 300, 7):
        ra, rb = a.request(i), b.request(i)
        assert ra == rb
        p, o = len(ra["prompt"]), ra["max_new_tokens"] + 1
        assert mix["prompt_tokens"]["low"] <= p <= mix["prompt_tokens"]["high"]
        assert mix["output_tokens"]["low"] <= o <= mix["output_tokens"]["high"]
        assert all(0 <= t < 49155 for t in ra["prompt"])


@pytest.mark.parametrize("name", sorted(n for n in MIXES if n != "train"))
def test_same_requests_every_seed(name):
    mix = _mix(name)
    blocks = []
    for seed in SEEDS:
        loop = ClosedLoop(mix, seed, 1000)
        blocks.append([Counter(loop.lengths(i)
                               for i in range(b * BLOCK, (b + 1) * BLOCK))
                       for b in range(3)])
    assert all(bl == blocks[0] for bl in blocks)
    assert blocks[0][0] == blocks[0][1]
    orders = {tuple(ClosedLoop(mix, s, 1000).lengths(i)
                    for i in range(3 * BLOCK)) for s in SEEDS}
    assert len(orders) == 1
    loop = ClosedLoop(mix, SEEDS[0], 1000)
    assert ([loop.lengths(i) for i in range(BLOCK)]
            != [loop.lengths(i) for i in range(BLOCK, 2 * BLOCK)])
    prompts = {tuple(ClosedLoop(mix, s, 1000).request(0)["prompt"])
               for s in SEEDS}
    assert len(prompts) == len(SEEDS)


def test_a_client_sends_every_clients_th_request():
    loop = ClosedLoop(_mix("chat"), 3, 100)
    assert loop.next_of(5) == 5 + loop.clients == 37


def test_train_batches_differ_and_repeat():
    a = train_batch(2 ** 35, 3, 4, 16, 100)
    b = train_batch(2 ** 35, 3, 4, 16, 100)
    c = train_batch(2 ** 35, 4, 4, 16, 100)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert len({r.tobytes() for r in a["tokens"]}) == 4
    assert np.array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])
