"""Runs with the timed path broken underneath come out not correct, and
so does the control: the reference in float8 in the program's place.

Each fault is planted in the program's serve path on the CPU at smoke
sizes, and the rest of the run (pilot, pool, clients, the comparison) is
the benchmark's own: an admission's token altered, a decode step's token
altered, half of the batch left out (the other half's new tokens
broadcast to its rows), and a decode step that returns its cache unchanged.  One
chip holds a cell, so no exchange between chips can be left out."""

import time

import pytest
import torch

from perfbench import bench
from perfbench.run import execute
from perfbench.tests.smoke import checkout

LIMITS = {"logit_gap": 0.03, "wrong_length": 0, "failed": 0}
CELLS = ["granite-smoke.tiny", "mamba2-smoke.tiny"]
SEED = 2 ** 33 + 1


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("bench"), limits=LIMITS)


def _admission_token(monkeypatch):
    from repro_torch.serving.engine import ServeEngine
    orig = ServeEngine._finish_admission

    def altered(self, si, req, plen, nxt):
        return orig(self, si, req, plen, (nxt + 1) % self.cfg.vocab_size)
    monkeypatch.setattr(ServeEngine, "_finish_admission", altered)


def _decode_token(monkeypatch):
    from repro_torch.serving.engine import ServeEngine
    orig = ServeEngine.step

    def altered(self):
        n = orig(self)
        for req in list(self._live.values()):
            if len(req.tokens) == 3:
                req.tokens[-1] = (req.tokens[-1] + 1) % self.cfg.vocab_size
        return n
    monkeypatch.setattr(ServeEngine, "step", altered)


def _half_batch(monkeypatch):
    """The second half of the slots gets the first half's new tokens, as
    a step computed over half of the batch and broadcast would give."""
    from repro_torch.serving.engine import ServeEngine
    orig = ServeEngine.step

    def half(self):
        rows = {si: m.rid for si, m in enumerate(self.slot_meta) if m.active}
        lens = {rid: len(self._live[rid].tokens) for rid in rows.values()}
        n = orig(self)

        def req(rid):
            return self._live.get(rid) or self.done.get(rid)
        h = self.slots // 2
        for si, rid in rows.items():
            src = rows.get(si - h) if si >= h else None
            if src is None or req(rid) is None or req(src) is None:
                continue
            r, k = req(rid), lens[rid]
            new = req(src).tokens[lens[src]:]
            r.tokens[k:] = new[:len(r.tokens) - k] + r.tokens[k + len(new):]
        return n
    monkeypatch.setattr(ServeEngine, "step", half)


def _state_unchanged(monkeypatch):
    from repro_torch.serving import engine
    orig = engine.make_engine_step

    def broken(bundle, max_len):
        step = orig(bundle, max_len)

        def unchanged(params, state, active, budget):
            saved = [{k: v.clone() for k, v in c.items()}
                     for c in state["cache"]]
            out = step(params, state, active, budget)
            for c, s in zip(state["cache"], saved):
                for k, v in c.items():
                    v.copy_(s[k])
            return out
        return unchanged
    monkeypatch.setattr(engine, "make_engine_step", broken)


FAULTS = {"admission_token": _admission_token, "decode_token": _decode_token,
          "half_batch": _half_batch, "state_unchanged": _state_unchanged}


def _program_within_limits(table):
    """The program's own readings of a control run, each within the limit
    of the number it stands beside."""
    own = {k[len("program_"):]: v["value"] for k, v in table.items()
           if k.startswith("program_")}
    assert own, table
    return all(v <= table[k]["limit"] for k, v in own.items())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_is_not(smoke_root, cell):
    """A control run judges the control in the program's place: it is not
    correct, while the program's own reading in that run is within the
    limit."""
    line, table = execute(cell, SEED, 1.0, False, "cpu", control=True,
                          root=smoke_root, t_process=time.monotonic())
    assert not line["correct"], table
    assert table["logit_gap"]["value"] > LIMITS["logit_gap"], table
    assert _program_within_limits(table), table


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(smoke_root, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    line, table = execute(cell, SEED, 1.0, False, "cpu", root=smoke_root,
                          t_process=time.monotonic())
    assert not line["correct"], table


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  bench.load_benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(card, cell):
    """The control at the cell's own size on the card: the float8
    reference in the program's place fails one of the cell's numbers,
    and the program's own readings of the run are within them."""
    line, table = execute(cell, 2 ** 31 + 77, 5.0, False, card, control=True)
    assert not line["correct"], table
    assert _program_within_limits(table), table


def _train_state_unchanged(monkeypatch):
    from repro_torch.core import images
    orig = images.make_train_step

    def broken(cfg, oc=None, **kw):
        step = orig(cfg, oc, **kw)

        def unchanged(state, batch):
            from repro_torch import tree
            live = [state["params"].live(), state["opt"]]
            saved = [t.detach().clone() for t in tree.leaves(live)]
            state, metrics = step(state, batch)
            with torch.no_grad():
                for t, s in zip(tree.leaves(live), saved):
                    t.copy_(s)
            return state, metrics
        return unchanged
    monkeypatch.setattr(images, "make_train_step", broken)


def _train_half_batch(monkeypatch):
    from repro_torch.core import images
    orig = images.make_train_step

    def broken(cfg, oc=None, **kw):
        step = orig(cfg, oc, **kw)

        def half(state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    monkeypatch.setattr(images, "make_train_step", broken)


def _replay_half_batch(monkeypatch):
    """Half of the batch left out of step 1 alone: the first call after
    step 0, the one a card replays from the captured graph."""
    from repro_torch.core import images
    orig = images.make_train_step

    def broken(cfg, oc=None, **kw):
        step = orig(cfg, oc, **kw)
        calls = [0]

        def half(state, batch):
            calls[0] += 1
            if calls[0] == 2:
                n = batch["tokens"].shape[0] // 2
                batch = {k: v[:n] for k, v in batch.items()}
            return step(state, batch)
        return half
    monkeypatch.setattr(images, "make_train_step", broken)


TRAIN_FAULTS = {"state_unchanged": _train_state_unchanged,
                "half_batch": _train_half_batch,
                "replay_half_batch": _replay_half_batch}


def test_sound_train_run_is_correct_and_control_is_not(smoke_root):
    line, table = execute("mamba2-smoke.tinytrain", SEED, 1.0, False, "cpu",
                          control=True, root=smoke_root,
                          t_process=time.monotonic())
    assert not line["correct"], table
    assert _program_within_limits(table), table


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_not_correct(smoke_root, monkeypatch, fault):
    TRAIN_FAULTS[fault](monkeypatch)
    line, table = execute("mamba2-smoke.tinytrain", SEED, 1.0, False, "cpu",
                          root=smoke_root, t_process=time.monotonic())
    assert not line["correct"], table


def test_replay_half_batch_shows_in_the_gradient(smoke_root, monkeypatch):
    """The gradient of step 1 is compared: a fault in that step alone
    moves ``grad_gap`` past its limit."""
    _replay_half_batch(monkeypatch)
    line, table = execute("mamba2-smoke.tinytrain", SEED, 1.0, False, "cpu",
                          root=smoke_root, t_process=time.monotonic())
    assert table["grad_gap"]["value"] > table["grad_gap"]["limit"], table
