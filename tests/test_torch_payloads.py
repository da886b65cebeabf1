"""The port's payloads against the JAX package's, through both run_wrappers.

Each payload mode is pulled from both packages' registries and run by both
packages' ``run_wrapper`` on the same inputs: the JAX image's parameters
(and a numpy prefill batch) are bridged into the port with
``repro_torch.bridge.params_from_numpy`` and injected here, in the test,
into the port's Executable.  Everything runs on the CPU at
``smollm-360m``'s smoke config with ``attn_impl`` and ``norm_impl``
"pallas" on both sides: the JAX kernels as the JAX package's own CPU tests
run them, the port's as their plain versions.

Tolerances: logits within ``LOGIT_TOL`` of tests/test_torch_model.py;
serve streams equal up to the first position where the JAX logits' top-2
margin is below ``MARGIN``, as tests/test_torch_engine.py compares them.
The rest: the serve telemetry's keys are the reference's, the slices the
port does not have yet raise naming their ROADMAP.md item, and a stop
from the pilot ends a serve payload with 143.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke
from repro.core.arena import SharedArena as JaxArena
from repro.core.images import ExecutableRegistry as JaxRegistry
from repro.core.images import PayloadImage as JaxImage
from repro.core.proctable import ProcessTable as JaxProcTable
from repro.core.wrapper import _SERVE_STAT_KEYS as JAX_SERVE_KEYS
from repro.core.wrapper import run_wrapper as jax_run_wrapper
from repro.models.api import build_model as jax_build
from repro.serving.engine import ServeEngine as JaxEngine
from repro.serving.engine import make_engine_step as jax_make_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.arena import SharedArena
from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import ExecutableRegistry, PayloadImage
from repro_torch.core.proctable import PAYLOAD_UID, ProcessTable
from repro_torch.core.wrapper import _SERVE_STAT_KEYS, run_wrapper
from repro_torch.launch.serve import make_trace
from repro_torch.models.api import build_model
from repro_torch.runtime.mesh import serve_mesh

ARCH = "smollm-360m"
FLAGS = (("attn_impl", "pallas"), ("norm_impl", "pallas"))
LOGIT_TOL = dict(rtol=1e-2, atol=1e-2)     # tests/test_torch_model.py:37
MARGIN = 2e-2                              # tests/test_torch_engine.py:38
CPU = "cpu"


def _images(mode, **kw):
    return (JaxImage(ARCH, "smoke", mode, flags=FLAGS, **kw),
            PayloadImage(ARCH, "smoke", mode, flags=FLAGS, **kw))


def _bridge(jparams):
    cfg = dataclasses.replace(get_smoke_config(ARCH), **dict(FLAGS))
    return params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                             device=CPU)


def _run_both(tmp_path, jexe, pexe, spec):
    """Both wrappers on one spec; returns ((exit, telemetry) JAX, port)."""
    out = []
    for run, arena, pt, exe in (
            (jax_run_wrapper, JaxArena(str(tmp_path / "jax")),
             JaxProcTable(), jexe),
            (run_wrapper, SharedArena(str(tmp_path / "port")),
             ProcessTable(), pexe)):
        code = run(arena, pt, exe, {"env": {"seed": 0}, **spec})
        got = arena.read_exit()
        assert got["exitcode"] == code
        out.append((code, got["telemetry"]))
    return out


def _recording(fn, outs):
    """``fn`` that appends its logits (the first output) to ``outs``."""
    def rec(*args):
        res = fn(*args)
        outs.append(np.asarray(jnp.asarray(res[0], jnp.float32))
                    if not isinstance(res[0], torch.Tensor)
                    else res[0].float().numpy())
        return res
    return rec


def _margin(row):
    top = np.sort(np.asarray(row, np.float32))[-2:]
    return float(top[1] - top[0])


# ---------------------------------------------------------------------------
# payload modes
# ---------------------------------------------------------------------------

def test_noop_payload(tmp_path):
    jexe = JaxRegistry().pull(JaxImage("placeholder", "none", "noop"))
    pexe = ExecutableRegistry().pull(
        PayloadImage("placeholder", "none", "noop"), CPU)
    (jc, jt), (pc, pt) = _run_both(tmp_path, jexe, pexe, {})
    assert jc == pc == 0 and jt["steps"] == pt["steps"] == 1


def test_prefill_payload_logits_match_jax(tmp_path):
    jimg, pimg = _images("prefill")
    jexe, pexe = JaxRegistry().pull(jimg), ExecutableRegistry().pull(pimg, CPU)
    jparams, _ = jexe.make_inputs(jax.random.key(0))
    shape = pimg.shape_spec()
    tokens = np.random.default_rng(1).integers(
        0, 512, size=(shape.global_batch, shape.seq_len)).astype(np.int32)
    jout, pout = [], []
    jexe = dataclasses.replace(
        jexe, fn=_recording(jexe.fn, jout),
        make_inputs=lambda key: (jparams, {"tokens": jnp.asarray(tokens)}))
    pparams = _bridge(jparams)
    pexe = dataclasses.replace(
        pexe, fn=_recording(pexe.fn, pout),
        make_inputs=lambda seed: (pparams,
                                  {"tokens": torch.from_numpy(tokens)}))
    (jc, _), (pc, pt) = _run_both(tmp_path, jexe, pexe, {})
    assert jc == pc == 0 and pt["steps"] == 1
    assert pout[0].shape == jout[0].shape == (shape.global_batch, 1, 512)
    np.testing.assert_allclose(pout[0], jout[0], **LOGIT_TOL)


def test_decode_payload_logits_match_jax(tmp_path):
    jimg, pimg = _images("decode")
    jexe, pexe = JaxRegistry().pull(jimg), ExecutableRegistry().pull(pimg, CPU)
    jparams, jstate = jexe.make_inputs(jax.random.key(0))
    pparams = _bridge(jparams)
    _, pstate = pexe.make_inputs(0)
    jout, pout = [], []
    jexe = dataclasses.replace(jexe, fn=_recording(jexe.fn, jout),
                               make_inputs=lambda key: (jparams, jstate))
    pexe = dataclasses.replace(pexe, fn=_recording(pexe.fn, pout),
                               make_inputs=lambda seed: (pparams, pstate))
    (jc, jt), (pc, pt) = _run_both(tmp_path, jexe, pexe, {"n_steps": 4})
    assert jc == pc == 0 and jt["steps"] == pt["steps"] == 4
    assert len(pout) == len(jout) == 4
    for mine, ref in zip(pout, jout):
        np.testing.assert_allclose(mine, ref, **LOGIT_TOL)


def test_decode_image_step_returns_the_state_it_was_given():
    """The decode image's ``fn`` writes ``token`` and ``pos`` into the
    state it was given and returns that state (on a card, the state its
    captured graph replays); its logits are the bundle's functional decode
    step's, chained."""
    pexe = ExecutableRegistry().pull(_images("decode")[1], CPU)
    params, state = pexe.make_inputs(0)
    held = {k: state[k] for k in ("token", "pos", "cache")}
    bundle = build_model(pexe.image.config())
    ref = {**state, "token": state["token"].clone(),
           "pos": state["pos"].clone(),
           "cache": [{k: v.clone() for k, v in leaf.items()}
                     for leaf in state["cache"]]}
    for _ in range(3):
        logits, out = pexe.fn(params, state)
        want, ref = bundle.decode(params, ref)
        assert out is state and torch.equal(logits, want)
    assert all(state[k] is v for k, v in held.items())
    assert torch.equal(state["token"], ref["token"])
    assert state["pos"].tolist() == [3] * state["pos"].shape[0]


def _jax_margins(jcfg, jparams, trace, max_len):
    """The JAX engine on ``trace``, recording the top-2 margin of every
    logits row that produced a token: {rid: [margins]} and its streams."""
    jb = jax_build(jcfg)
    base_step = jax_make_step(jb, max_len)
    decode, prefill = jax.jit(jb.decode), jax.jit(jb.prefill)
    margins: dict[int, list[float]] = {}
    holder = {}

    def prefill_fn(p, batch):
        logits, cache = prefill(p, batch)
        margins[holder["eng"].queue[0].rid] = [_margin(logits[0, -1])]
        return logits, cache

    def step_fn(p, state, active, budget):
        logits, _ = decode(p, state)
        rows = np.asarray(logits[:, -1], np.float32)
        for si, m in enumerate(holder["eng"].slot_meta):
            if m.active:
                margins[m.rid].append(_margin(rows[si]))
        return base_step(p, state, active, budget)

    eng = JaxEngine(jcfg, jparams, slots=2, max_len=max_len, bundle=jb,
                    step_fn=step_fn, prefill_fn=prefill_fn)
    holder["eng"] = eng
    eng.run_trace(trace)
    return margins, {str(rid): r.tokens for rid, r in eng.done.items()}


@pytest.mark.parametrize("draft", [None, ARCH], ids=["spec_off", "draft"])
def test_serve_payload_streams_match_jax(tmp_path, draft, record_property):
    jimg, pimg = _images("serve", draft=draft)
    jexe, pexe = JaxRegistry().pull(jimg), ExecutableRegistry().pull(pimg, CPU)
    jparams = jexe.make_inputs(jax.random.key(0))
    pparams = _bridge(jparams)
    pfn = factory = pexe.fn
    if draft is not None:
        # the JAX factory's draft weights (its fixed key 0), bridged
        dparams = params_from_numpy(
            jax.tree.map(np.asarray,
                         jax_build(jax_smoke(draft)).init(jax.random.key(0))),
            get_smoke_config(draft), device=CPU)
        pfn = lambda p, **kw: factory(p, draft_params=dparams, **kw)  # noqa: E731
    pexe = dataclasses.replace(pexe, fn=pfn, make_inputs=lambda seed: pparams)
    trace = make_trace(512, 5, max_len=64, seed=3)
    spec = {"trace": trace, "max_len": 64, "n_steps": 500}
    (jc, jt), (pc, pt) = _run_both(tmp_path, jexe, pexe, spec)
    assert jc == pc == 0, (jt.get("error"), pt.get("error"))
    assert pt["serve"]["spec"] == jt["serve"]["spec"] == (
        "draft" if draft else "off")
    assert pt["serve"]["completed"] == jt["serve"]["completed"] == 5
    assert pt["serve"]["d2h_transfers"] == pt["serve"]["decode_steps"]
    jcfg = dataclasses.replace(jax_smoke(ARCH), **dict(FLAGS))
    margins, jstreams = _jax_margins(jcfg, jparams, trace, 64)
    assert jstreams == jt["tokens"]          # speculation commits spec-off's
    compared = 0
    for rid, ref in jt["tokens"].items():
        mine = pt["tokens"][rid]
        assert len(mine) == len(ref) == len(margins[int(rid)])
        n = next((j for j, m in enumerate(margins[int(rid)]) if m < MARGIN),
                 len(ref))
        assert mine[:n] == ref[:n], (rid, n)
        compared += n
    record_property("positions_compared", compared)
    assert compared > 0


def test_serve_telemetry_has_the_reference_keys(tmp_path):
    jimg, pimg = _images("serve")
    exes = JaxRegistry().pull(jimg), ExecutableRegistry().pull(pimg, CPU)
    spec = {"trace": make_trace(512, 2, max_len=64, seed=0), "max_len": 64}
    (jc, jt), (pc, pt) = _run_both(tmp_path, *exes, spec)
    assert jc == pc == 0
    assert tuple(_SERVE_STAT_KEYS) == tuple(JAX_SERVE_KEYS)
    assert set(pt["serve"]) == set(jt["serve"]) == set(JAX_SERVE_KEYS)
    for key in ("mesh_shape", "mesh_devices", "role", "prefills_exported",
                "handoffs_imported"):
        assert pt["serve"][key] == jt["serve"][key], key
    assert (pt["serve"]["kv_pool_bytes_per_device"]
            == pt["serve"]["kv_pool_bytes"])


# ---------------------------------------------------------------------------
# what the port does not have yet raises, naming its ROADMAP.md item
# ---------------------------------------------------------------------------

def test_train_image_raises_naming_item_4(tmp_path):
    """The train image (ROADMAP.md Queue 1 item 4) pulls and runs one step
    through both packages' wrappers from the same state (the reference image's, bridged
    into the port's Executable): the same loss, within the loss tolerance
    of tests/test_torch_train.py; on the kernel flags it refuses its pull,
    naming the missing VJP."""
    from repro_torch.bridge import train_state_from_numpy
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    jexe = JaxRegistry().pull(JaxImage(ARCH, "smoke", "train"))
    pexe = ExecutableRegistry().pull(PayloadImage(ARCH, "smoke", "train"),
                                     CPU)
    cfg = get_smoke_config(ARCH)
    jstate, jdata = jexe.make_inputs(jax.random.key(0))
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device=CPU)
    pexe.make_inputs = lambda seed: (state, SyntheticLM(SyntheticConfig(
        cfg.vocab_size, jdata.cfg.seq_len, jdata.cfg.global_batch)))
    (jc, jt), (pc, pt) = _run_both(tmp_path, jexe, pexe, {"n_steps": 1})
    assert jc == pc == 0 and jt["steps"] == pt["steps"] == 1
    assert abs(pt["first_loss"] - jt["first_loss"]) < 2e-3
    assert int(state["opt"]["step"]) == 1
    with pytest.raises(NotImplementedError, match="no VJP"):
        ExecutableRegistry().pull(PayloadImage(ARCH, "smoke", "train",
                                               flags=FLAGS), CPU)


@pytest.mark.parametrize("image_kw, spec_kw, shape", [
    (dict(mesh_shape=(2, 1)), {}, [2, 1]),
    ({}, dict(mesh_shape=[2, 1]), [2, 1]),
], ids=["image_mesh", "spec_mesh"])
def test_later_serve_slices_raise(tmp_path, image_kw, spec_kw, shape):
    """A mesh with a data axis above 1 (a copy of the engine's placement
    on each data row) serves: an image or a startup spec asking for one on
    a slice that holds two CPU ranks runs to exit code 0, its telemetry
    naming the mesh, its streams those of the one-device image."""
    trace = make_trace(512, 2, max_len=64)
    runs = []
    for kw, where, spec in ((image_kw, serve_mesh((2, 1), (CPU, CPU)),
                             spec_kw), ({}, CPU, {})):
        exe = ExecutableRegistry().pull(
            PayloadImage(ARCH, "smoke", "serve", **kw), where)
        arena = SharedArena(str(tmp_path / f"a{len(runs)}"))
        code = run_wrapper(arena, ProcessTable(), exe,
                           {"trace": trace, "max_len": 64, **spec})
        runs.append((code, arena.read_exit()["telemetry"]))
    (code, tel), (code1, tel1) = runs
    assert code == code1 == 0, tel.get("error")
    assert list(tel["serve"]["mesh_shape"]) == shape
    assert tel["serve"]["mesh_devices"] == 2
    assert tel["tokens"] == tel1["tokens"]


def test_build_mesh_raises_naming_item_8():
    """`build_mesh` places the image's mesh on the slice's devices (none
    for an image of one device); on a mesh whose data axis is above 1 the
    params are placed on data row 0 with a copy on every other row."""
    from repro_torch.runtime.sharding import shard_params
    assert PayloadImage(ARCH, "smoke", "serve").build_mesh() is None
    mesh = PayloadImage(ARCH, "smoke", "serve",
                        mesh_shape=(1, 2)).build_mesh((CPU, CPU))
    assert mesh.shape == {"data": 1, "model": 2}
    wide = PayloadImage(ARCH, "smoke", "serve",
                        mesh_shape=(2, 1)).build_mesh((CPU, CPU))
    params = ExecutableRegistry().pull(
        PayloadImage(ARCH, "smoke", "serve"), CPU).make_inputs(0)
    sp = shard_params(params, wide)
    (copy,) = sp.replicas
    assert torch.equal(copy["embed"], sp.embed)
    assert copy["embed"].data_ptr() != sp.embed.data_ptr()
    assert sp.expert_rows == 1                 # smollm has no experts


# ---------------------------------------------------------------------------
# stopping, and the card
# ---------------------------------------------------------------------------

def test_run_trace_stops_when_on_tick_says_so():
    exe = ExecutableRegistry().pull(PayloadImage(ARCH, "smoke", "serve"), CPU)
    eng = exe.fn(exe.make_inputs(0), max_len=64)
    ticks = []

    def on_tick(tick, dt):
        ticks.append((tick, dt))
        return tick < 3

    stats = eng.run_trace(make_trace(512, 4, max_len=64), on_tick=on_tick)
    assert [t for t, _ in ticks] == [1, 2, 3]
    assert all(dt >= 0 for _, dt in ticks)
    assert stats["decode_steps"] <= 3 and stats["completed"] < 4


def test_stop_from_the_pilot_exits_143(tmp_path):
    """The pilot's SIGTERM (the payload uid's stop event) lands between two
    ticks: ``on_tick`` returns False and the wrapper reports 143."""
    exe = ExecutableRegistry().pull(PayloadImage(ARCH, "smoke", "serve"), CPU)
    pt = ProcessTable()

    def factory(params, **kw):
        eng = exe.fn(params, **kw)
        step = eng.step

        def stepping():
            if eng.steps == 2:
                pt.kill_uid(PAYLOAD_UID)
            return step()
        eng.step = stepping
        return eng

    arena = SharedArena(str(tmp_path / "a"))
    code = run_wrapper(arena, pt, dataclasses.replace(exe, fn=factory),
                       {"trace": make_trace(512, 4, max_len=64),
                        "max_len": 64, "n_steps": 500})
    tel = arena.read_exit()["telemetry"]
    assert code == 143 and "serve" not in tel
    assert tel["steps"] <= 3


def test_cluster_sim_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterSim()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExecutableRegistry().pull(PayloadImage("placeholder", "none", "noop"))
    assert ClusterSim(device=CPU).provision(1)[0].device.type == "cpu"
