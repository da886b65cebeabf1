"""`repro_torch.serving.graph.SharedOutput` on the CPU: the one-shot
admission graphs' one output.  A tree placed under a capture that does
not fit becomes the shared one (the CPU stands in for the capture here);
a tree that fits is copied into views of it, equal to what was placed;
one that does not fit outside a capture comes back as it is."""

import pytest
import torch

from repro_torch.serving import graph
from repro_torch.serving.graph import SharedOutput


def _tree(n: int):
    g = torch.Generator().manual_seed(n)
    return (torch.randn((1, 1, 7), generator=g),
            [{"k": torch.randn((2, 1, n, 3), generator=g).bfloat16(),
              "v": torch.randint(0, 9, (2, 1, n), generator=g,
                                 dtype=torch.int32)},
             {"conv": torch.randn((1, 5), generator=g).half()}])


def _leaves(tree):
    logits, layers = tree
    return [logits] + [t for layer in layers for t in layer.values()]


@pytest.fixture
def capturing(monkeypatch):
    state = {"on": False}
    monkeypatch.setattr(graph, "_capturing", lambda device: state["on"])
    return state


def test_the_largest_output_is_kept_and_a_smaller_one_is_a_view_of_it(
        capturing):
    shared = SharedOutput()
    big = _tree(32)
    assert shared.place(big) is big and shared.ref is None   # a warm-up
    capturing["on"] = True
    assert shared.place(big) is big and shared.generation == 1
    small = _tree(8)
    got = shared.place(small)
    assert shared.generation == 1
    for g, w, r in zip(_leaves(got), _leaves(small), _leaves(big)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
        assert g.data_ptr() == r.data_ptr()
    # the shared leaves now hold the smaller output at their front
    assert torch.equal(_leaves(big)[1].view(-1)[:_leaves(small)[1].numel()],
                       _leaves(small)[1].view(-1))


def test_a_larger_output_replaces_the_shared_one_under_a_capture_only(
        capturing):
    shared = SharedOutput()
    capturing["on"] = True
    small = _tree(8)
    shared.place(small)
    large = _tree(64)
    capturing["on"] = False
    assert shared.place(large) is large and shared.generation == 1
    capturing["on"] = True
    assert shared.place(large) is large and shared.generation == 2
    assert all(a is b for a, b in zip(shared.ref, _leaves(large)))
    # another tree (one leaf fewer) does not fit either
    logits, layers = _tree(4)
    assert shared.place((logits, layers[:1])) is not None
    assert shared.generation == 3


def test_a_sharded_leaf_is_shared_part_by_part(capturing):
    """A tensor-parallel engine's prefill cache (`Shards` leaves, its ranks
    on one device) is shared part by part and comes back as `Shards`."""
    from repro_torch.runtime.sharding import Shards

    def sharded(n):
        logits, layers = _tree(n)
        k = layers[0]["k"]
        return (logits, [{"k": Shards([c.contiguous()
                                       for c in k.chunk(2, dim=-1)], -1)}])

    shared = SharedOutput()
    capturing["on"] = True
    big = sharded(32)
    shared.place(big)
    assert len(shared.ref) == 3
    small = sharded(8)
    got = shared.place(small)
    assert isinstance(got[1][0]["k"], Shards) and got[1][0]["k"].dim == -1
    for g, w, r in zip(got[1][0]["k"].parts, small[1][0]["k"].parts,
                       big[1][0]["k"].parts):
        assert torch.equal(g, w) and g.data_ptr() == r.data_ptr()
    # parts that are not contiguous stay their graph's own output
    other = SharedOutput()
    k = _tree(16)[1][0]["k"]
    tree = [Shards(k.chunk(2, dim=-1), -1)]
    assert other.place(tree) is tree and other.ref is None
