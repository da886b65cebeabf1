"""The port's training payload against the JAX package, on the CPU.

Loss, gradients, AdamW, compression, synthetic data, the train step and
checkpoints of ``src/repro_torch/`` are held to ``src/repro/`` at the smoke
configs of smollm-360m, granite-moe-3b-a800m and mamba2-370m: parameters
come from ``repro.models.api.build_model(cfg).init`` (f32) and are bridged
with ``repro_torch.bridge``; inputs come from a numpy seed.  Both packages
train on their plain paths (the configs' defaults).  Then the port's own
claims: the serve views of ``LMParams`` stay as they were while the train
path reaches every parameter, every kernel wrapper refuses an input that
requires grad (as ``jax.grad`` fails through the reference's kernels),
checkpoints restore across the two packages and across pilots, and the
checkpoint's durability contracts hold on torch trees.

Tolerances, each stated where it is used:

* ``LOSS_TOL``: the loss is an f32 mean over bf16 logits; the two
  libraries round the same products at the same points but sum in other
  orders, 2e-4 apart measured (abs 2e-3 allowed, 1e-2 for the MoE aux
  loss, whose routing counts move by 1/(B*S) per flipped token).
* ``GRAD_TOL``: per leaf, ||g - g_ref|| / ||g_ref||.  With f32 compute the
  math alone is compared (1.2e-3 measured, from the attention's fixed bf16
  operands): 5e-3.  With the default bf16 compute each backward product
  rounds to bf16 in its own order (up to 3.5e-2 measured, on granite's
  router, whose gradient passes through the bf16 expert outputs): 5e-2.
* f32 elementwise arithmetic (AdamW, compression, the fused CE against the
  plain CE): rtol 1e-5, atol 1e-7 (a few f32 ulps: XLA and torch evaluate
  ``pow``, ``sqrt`` and divisions to the ulp, not bit for bit).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.ckpt import checkpoint as jax_ck
from repro.configs.base import get_smoke_config as jax_smoke
from repro.data.synthetic import SyntheticConfig as JaxSynthCfg
from repro.data.synthetic import SyntheticLM as JaxSynth
from repro.launch.steps import init_train_state as jax_init_state
from repro.launch.steps import make_train_step as jax_make_step
from repro.models.api import build_model as jax_build
from repro.models import layers as jax_layers
from repro.optim import adamw as jax_adamw
from repro.runtime import compression as jax_comp
from repro_torch import tree
from repro_torch.bridge import (
    params_from_numpy, train_state_from_numpy, train_state_to_numpy)
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import PayloadImage
from repro_torch.core.pilot import PilotConfig
from repro_torch.core.taskrepo import TaskRepo
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM, to_device
from repro_torch.launch.serve import KERNEL_FLAGS, serve_direct
from repro_torch.launch.steps import (
    GRAPH_KEY, init_train_state, load_train_state, make_train_step,
    state_tree)
from repro_torch.launch.train import train_direct, train_via_pilots
from repro_torch.models import layers
from repro_torch.models import transformer
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import compression

ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "mamba2-370m")
LOSS_TOL = 2e-3
AUX_TOL = 1e-2
GRAD_TOL = {"f32": 5e-3, "bf16": 5e-2}
F32_TOL = dict(rtol=1e-5, atol=1e-7)
CPU = "cpu"
B, S = 2, 64


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


_TREES: dict = {}


def _ref_params(arch):
    """The reference's f32 parameters of ``arch``'s smoke config (numpy)."""
    if arch not in _TREES:
        _, jcfg = _cfgs(arch)
        _TREES[arch] = jax.tree.map(
            np.asarray, jax_build(jcfg).init(jax.random.key(0)))
    return _TREES[arch]


_GRADS: dict = {}
GRAD_BATCH_SEED = 1


def _ref_grads(arch, compute):
    """``jax.grad`` of the reference's loss of ``arch`` at ``compute``
    ("f32" or "bf16") on the batch of ``GRAD_BATCH_SEED`` (numpy)."""
    if (arch, compute) not in _GRADS:
        cfg, jcfg = _cfgs(arch)
        jb = jax_build(jcfg, compute=jnp.float32 if compute == "f32"
                       else jnp.bfloat16)
        nb = jax.tree.map(jnp.asarray, _batch(cfg.vocab_size,
                                              seed=GRAD_BATCH_SEED))
        g = jax.jit(jax.grad(lambda p: jb.loss(p, nb)[0]))(_ref_params(arch))
        _GRADS[(arch, compute)] = jax.tree.map(np.asarray, g)
    return _GRADS[(arch, compute)]


def _port_params(arch, cfg):
    params = params_from_numpy(_ref_params(arch), cfg, device=CPU,
                               matrix_dtype=torch.float32)
    return params.requires_grad_(True)


def _batch(vocab, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "targets")}


def _torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch):
    """``ModelBundle.loss`` (``transformer.lm_loss``): the loss, ``ce`` and
    ``aux`` apart, on bridged parameters at the default bf16 compute."""
    cfg, jcfg = _cfgs(arch)
    nb = _batch(cfg.vocab_size)
    jl, jm = jax.jit(jax_build(jcfg).loss)(_ref_params(arch),
                                           jax.tree.map(jnp.asarray, nb))
    with torch.no_grad():
        l, m = build_model(cfg).loss(_port_params(arch, cfg), _torch_batch(nb))
    assert abs(float(m["ce"]) - float(jm["ce"])) < LOSS_TOL
    assert abs(float(l) - float(jl)) < LOSS_TOL
    if cfg.moe is None:
        assert float(m["aux"]) == float(jm["aux"]) == 0.0
    else:
        assert float(jm["aux"]) > 0
        assert abs(float(m["aux"]) - float(jm["aux"])) < AUX_TOL * float(jm["aux"])


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_leaf_matches_jax_grad(arch, compute):
    """Every leaf of the port's gradient against ``jax.grad`` of the
    reference's loss, as ||g - g_ref|| / ||g_ref|| (``GRAD_TOL``); none is
    missing or zero where the reference's is not (the trap of training on
    views of ``.data``)."""
    cfg, _ = _cfgs(arch)
    tdt = torch.float32 if compute == "f32" else torch.bfloat16
    nb = _batch(cfg.vocab_size, seed=GRAD_BATCH_SEED)
    params = _port_params(arch, cfg)
    loss, _ = build_model(cfg, compute=tdt).loss(params, _torch_batch(nb))
    loss.backward()
    want = jax.tree_util.tree_leaves_with_path(_ref_grads(arch, compute))
    mine = tree.leaves(params.live())
    assert len(mine) == len(want)
    for (path, g), p in zip(want, mine):
        name = jax.tree_util.keystr(path)
        assert p.grad is not None, name
        got = p.grad.numpy()
        assert got.shape == g.shape and np.isfinite(got).all(), name
        assert np.abs(g).max() > 0 and np.abs(got).max() > 0, name
        assert _rel(got, g) < GRAD_TOL[compute], (name, _rel(got, g))


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_fused_cross_entropy_matches_jax(softcap):
    """``softmax_cross_entropy_fused`` with ``chunk`` below S (40 tokens in
    16-token chunks: the last padded) and a mask, value and gradients
    against the reference's, f32 throughout; and its ``S <= chunk`` path is
    the plain CE."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 40, 16)).astype(np.float32)
    head = (rng.standard_normal((16, 96)) * 0.3).astype(np.float32)
    tgt = rng.integers(0, 96, (2, 40)).astype(np.int32)
    mask = (rng.random((2, 40)) < 0.7).astype(np.float32)

    def jloss(h, head):
        return jax_layers.softmax_cross_entropy_fused(
            h, head, jnp.asarray(tgt), softcap=softcap,
            mask=jnp.asarray(mask), chunk=16)
    jv, (jgh, jghead) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_(True)
    thead = torch.from_numpy(head).requires_grad_(True)
    v = layers.softmax_cross_entropy_fused(
        th, thead, torch.from_numpy(tgt), softcap=softcap,
        mask=torch.from_numpy(mask), chunk=16)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(jv), **F32_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(thead.grad.numpy(), np.asarray(jghead),
                               rtol=1e-5, atol=1e-6)
    plain = layers.softmax_cross_entropy(
        layers.lm_logits(th, thead, softcap), torch.from_numpy(tgt),
        torch.from_numpy(mask))
    one = layers.softmax_cross_entropy_fused(
        th, thead, torch.from_numpy(tgt), softcap=softcap,
        mask=torch.from_numpy(mask), chunk=64)
    assert torch.equal(one, plain)
    np.testing.assert_allclose(float(v.detach()), float(plain.detach()),
                               **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_loss_and_gradients(arch):
    """``remat`` "full" (recompute each group), "dots" (keep the matmul
    outputs) and "none" change what backward recomputes, not what it
    computes: bitwise the same loss and gradients on the CPU."""
    out = {}
    nb = _batch(get_smoke_config(arch).vocab_size, seed=2)
    for remat in ("full", "dots", "none"):
        cfg, _ = _cfgs(arch, remat=remat)
        params = _port_params(arch, cfg)
        loss, _ = build_model(cfg).loss(params, _torch_batch(nb))
        loss.backward()
        out[remat] = [loss.detach()] + [p.grad for p in
                                        tree.leaves(params.live())]
    for remat in ("dots", "none"):
        for a, b in zip(out["full"], out[remat]):
            assert torch.equal(a, b), remat


def _rng_spy(module, monkeypatch, force=None):
    """Replace ``module.checkpoint`` by one that records the
    ``preserve_rng_state`` each call asks for, and passes ``force`` in its
    place when given; returns the list of recorded values."""
    seen = []

    def spy(*a, **kw):
        seen.append(kw.get("preserve_rng_state", True))
        if force is not None:
            kw["preserve_rng_state"] = force
        return checkpoint(*a, **kw)
    monkeypatch.setattr(module, "checkpoint", spy)
    return seen


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_without_rng_state_is_bitwise_the_rng_preserving_one(
        arch, remat, monkeypatch):
    """``_remat`` recomputes without saving the generators' state
    (``preserve_rng_state=False``: the train forward draws no random
    numbers, and a captured CUDA graph then holds no generator state):
    bitwise the loss and every gradient of the same recompute with the
    state saved and restored (torch's default)."""
    cfg, _ = _cfgs(arch, remat=remat)
    nb = _batch(cfg.vocab_size, seed=2)
    out = {}
    for force in (None, True):
        seen = _rng_spy(transformer, monkeypatch, force)
        params = _port_params(arch, cfg)
        loss, _ = build_model(cfg).loss(params, _torch_batch(nb))
        loss.backward()
        assert seen and not any(seen)        # every group asks for False
        out[force] = [loss.detach()] + [p.grad for p in
                                        tree.leaves(params.live())]
    for a, b in zip(out[None], out[True], strict=True):
        assert torch.equal(a, b)


def test_fused_ce_recompute_without_rng_state_is_bitwise(monkeypatch):
    """The fused cross entropy's chunks recompute without the generators'
    state too: over 4 chunks, bitwise the loss and gradients of the
    recompute that saves it."""
    rng = np.random.default_rng(4)
    h0 = torch.from_numpy(rng.normal(size=(2, 64, 32)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(32, 50)).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, 50, (2, 64)))
    out = {}
    for force in (None, True):
        seen = _rng_spy(layers, monkeypatch, force)
        h, w = h0.clone().requires_grad_(), w0.clone().requires_grad_()
        loss = layers.softmax_cross_entropy_fused(h, w, tgt, chunk=16)
        loss.backward()
        assert len(seen) == 4 and not any(seen)
        out[force] = (loss.detach(), h.grad, w.grad)
    for a, b in zip(out[None], out[True]):
        assert torch.equal(a, b)


def test_serve_views_unchanged_and_train_reads_live_parameters():
    """``LMParams.group`` (the serve paths' cached views of ``.data``) is
    what it was: no gradient reaches through it, even once the parameters
    require grad.  ``live_groups`` are fresh slices of the parameters on
    each call, through which a loss reaches them."""
    cfg, _ = _cfgs("smollm-360m")
    params = _port_params("smollm-360m", cfg)
    served = params.group(0)
    assert served is params.group(0)                 # built once, cached
    wq = served[0]["mixer"]["wq"]
    assert not wq.requires_grad and wq.grad_fn is None
    live = params.live_groups()[0]
    assert live is not params.live_groups()[0]
    assert live[0]["mixer"]["wq"].requires_grad
    assert torch.equal(live[0]["mixer"]["wq"], wq)
    live[0]["mixer"]["wq"].sum().backward()
    assert params.layers[0]["mixer"]["wq"].grad[0].eq(1).all()
    assert params.layers[0]["mixer"]["wq"].grad[1:].eq(0).all()
    # serving builds frozen parameters
    frozen = build_model(cfg).init(0, device=CPU)
    assert not any(p.requires_grad for p in frozen.parameters())


# ---------------------------------------------------------------------------
# optimizer, compression, data
# ---------------------------------------------------------------------------

def test_cosine_lr_and_global_norm_match_jax():
    oc = adamw.OptimConfig(warmup_steps=10, total_steps=200)
    for step in (0, 1, 5, 9, 10, 11, 100, 199, 200, 500):
        want = float(jax_adamw.cosine_lr(oc, jnp.asarray(step, jnp.int32)))
        got = float(adamw.cosine_lr(oc, torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, **F32_TOL)
    rng = np.random.default_rng(4)
    grads = {"a": rng.standard_normal((3, 5)).astype(np.float32),
             "b": [rng.standard_normal(7).astype(np.float32) * 1e-3,
                   rng.standard_normal((2, 2)).astype(np.float32) * 40]}
    np.testing.assert_allclose(
        float(adamw.global_norm(tree.map_leaves(torch.from_numpy, grads))),
        float(jax_adamw.global_norm(grads)), **F32_TOL)


def _adamw_both(params_np, grads_np, oc, steps, transforms=(None, None)):
    """``steps`` AdamW updates of both packages, each fed the same numpy
    gradients every step; returns both states as numpy trees."""
    jp = jax.tree.map(jnp.asarray, params_np)
    jopt = jax_adamw.init_opt_state(jp)
    tp = tree.map_leaves(lambda a: torch.from_numpy(a.copy()), params_np)
    topt = adamw.init_opt_state(tp)
    metrics = []
    jupdate = (jax.jit(lambda p, g, o: jax_adamw.adamw_update(p, g, o, oc))
               if transforms[0] is None else
               lambda p, g, o: jax_adamw.adamw_update(
                   p, g, o, oc, grad_transform=transforms[0]))
    for i in range(steps):
        jg = jax.tree.map(jnp.asarray, grads_np[i])
        jp, jopt, jm = jupdate(jp, jg, jopt)
        tm = adamw.adamw_update(
            tp, tree.map_leaves(lambda a: torch.from_numpy(np.array(a)),
                                grads_np[i]), topt, oc,
            grad_transform=transforms[1])
        metrics.append(((float(jm["grad_norm"]), float(jm["lr"])),
                        (float(tm["grad_norm"]), float(tm["lr"]))))
    j = jax.tree.map(np.asarray, {"params": jp, "opt": jopt})
    t = {"params": tree.map_leaves(lambda x: x.numpy(), tp),
         "opt": tree.map_leaves(lambda x: x.numpy(), topt)}
    return j, t, metrics


def _assert_trees_close(got, want, **tol):
    gl, wl = tree.leaves(got), tree.leaves(want)
    assert len(gl) == len(wl) == len(jax.tree.leaves(want))
    for g, w in zip(gl, wl):
        assert np.asarray(g).shape == np.asarray(w).shape
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_update_matches_jax_on_the_models_gradients(arch):
    """One ``adamw_update`` of each package on the arch's parameter tree,
    fed the same numpy gradients (``jax.grad`` of the reference's loss),
    with a clip that binds: parameters, moments, step, norm and lr agree in
    f32."""
    oc = adamw.OptimConfig(warmup_steps=1, clip_norm=0.05)
    j, t, metrics = _adamw_both(_ref_params(arch),
                                [_ref_grads(arch, "bf16")], oc, 1)
    (jn, jlr), (tn, tlr) = metrics[0]
    assert jn > oc.clip_norm
    np.testing.assert_allclose((tn, tlr), (jn, jlr), **F32_TOL)
    _assert_trees_close(t, j, rtol=1e-5, atol=1e-7)
    assert int(t["opt"]["step"]) == int(j["opt"]["step"]) == 1


def test_adamw_steps_with_compression_match_jax():
    """Four updates with varying gradients (the clip binding on two), the
    lr through warm-up into the cosine, and the int8 error-feedback hook
    as ``grad_transform`` in both packages."""
    rng = np.random.default_rng(6)
    params = {"w": rng.standard_normal((4, 6)).astype(np.float32),
              "layers": [{"a": rng.standard_normal(5).astype(np.float32)},
                         {"a": rng.standard_normal(5).astype(np.float32)}]}
    grads = [jax.tree.map(lambda x, s=s: (rng.standard_normal(x.shape)
                                          * s).astype(np.float32), params)
             for s in (0.1, 3.0, 0.01, 2.0)]
    oc = adamw.OptimConfig(warmup_steps=2, total_steps=6, clip_norm=1.0)
    jres = [jax_comp.init_residuals(jax.tree.map(jnp.asarray, params))]
    tres = [compression.init_residuals(tree.map_leaves(torch.from_numpy,
                                                       params))]

    def jt(g):
        dq, jres[0] = jax_comp.compress(g, jres[0])
        return dq

    def tt(g):
        dq, tres[0] = compression.compress(g, tres[0])
        return dq
    j, t, metrics = _adamw_both(params, grads, oc, 4, (jt, tt))
    for (jn, jlr), (tn, tlr) in metrics:
        np.testing.assert_allclose((tn, tlr), (jn, jlr), **F32_TOL)
    _assert_trees_close(t, j, rtol=1e-5, atol=1e-7)
    _assert_trees_close(tree.map_leaves(lambda x: x.numpy(), tres[0]),
                        jax.tree.map(np.asarray, jres[0]), rtol=1e-5,
                        atol=1e-6)


def test_compress_matches_jax():
    """Dequantized gradients and residuals of one int8 round trip, from a
    nonzero residual, and the payload accounting."""
    rng = np.random.default_rng(7)
    g = {"a": rng.standard_normal((8, 9)).astype(np.float32) * 0.3,
         "b": [rng.standard_normal(13).astype(np.float32) * 1e-4,
               np.zeros((3,), np.float32)]}
    r = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3).astype(
        np.float32), g)
    jdq, jr = jax_comp.compress(jax.tree.map(jnp.asarray, g),
                                jax.tree.map(jnp.asarray, r))
    tdq, tr = compression.compress(tree.map_leaves(torch.from_numpy, g),
                                   tree.map_leaves(torch.from_numpy, r))
    for got, want in ((tdq, jdq), (tr, jr)):
        _assert_trees_close(tree.map_leaves(lambda x: x.numpy(), got),
                            jax.tree.map(np.asarray, want), rtol=1e-6,
                            atol=1e-9)
    assert compression.payload_bytes(tree.map_leaves(torch.from_numpy, g)) \
        == jax_comp.payload_bytes(jax.tree.map(jnp.asarray, g)) == (352, 100)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_are_bitwise_the_references(seed):
    cfg = SyntheticConfig(vocab_size=97, seq_len=33, global_batch=3, seed=seed)
    mine = SyntheticLM(cfg)
    ref = JaxSynth(JaxSynthCfg(97, 33, 3, seed=seed))
    for step in (0, 1, 7, 1000):
        a, b = mine.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert np.array_equal(a["tokens"], b["tokens"])
    dev = to_device(mine.batch_at(2), CPU)
    assert dev["targets"].dtype == torch.int32
    assert np.array_equal(dev["targets"].numpy(), ref.batch_at(2)["targets"])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _jax_state(jcfg, seed=0):
    return jax_init_state(jcfg, jax.random.key(seed))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch):
    """Three ``make_train_step`` steps of each package from the same
    state (the reference's ``init_train_state``, bridged), on the same
    synthetic batches: loss per step within LOSS_TOL, ``grad_norm`` within
    2 %, the same lr, and the port's state back in the reference's
    layout."""
    cfg, jcfg = _cfgs(arch)
    oc = adamw.OptimConfig(warmup_steps=2, total_steps=20, peak_lr=1e-2)
    jstate = _jax_state(jcfg)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device=CPU)
    jstep = jax.jit(jax_make_step(jcfg, oc))
    step = make_train_step(cfg, oc)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, S, B))
    for i in range(3):
        nb = data.batch_at(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, nb))
        state, m = step(state, to_device(nb, CPU))
        assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_TOL, i
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-2)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), **F32_TOL)
    back = train_state_to_numpy(state)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jstate))
    assert int(back["opt"]["step"]) == 3


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m"])
def test_step_graph_on_a_cpu_state_is_the_eager_step(arch):
    """``step_graph`` (on by default) captures only a state on a CUDA
    device: on the CPU three steps with it on are bitwise three with it
    off (every metric and every leaf of the state), and no graph is kept
    in the state.  (`test_three_train_steps_match_jax` holds that step to
    JAX.)"""
    cfg, _ = _cfgs(arch)
    oc = adamw.OptimConfig(warmup_steps=2, total_steps=20, peak_lr=1e-2)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, S, B))
    runs = {}
    for graph in (True, False):
        state = init_train_state(cfg, 0, CPU)
        step = make_train_step(cfg, oc, step_graph=graph)
        ms = [step(state, to_device(data.batch_at(i), CPU))[1]
              for i in range(3)]
        assert GRAPH_KEY not in state
        runs[graph] = (ms, tree.leaves(state_tree(state)))
    for a, b in zip(runs[True][0], runs[False][0]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(runs[True][1], runs[False][1], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flag, arch", [
    ("attn_impl", "smollm-360m"), ("norm_impl", "smollm-360m"),
    ("moe_impl", "granite-moe-3b-a800m"), ("ssm_impl", "mamba2-370m")])
def test_a_kernel_flag_train_step_raises_as_jax_grad_does(flag, arch):
    """A train step whose config selects a hand-written kernel raises in
    both packages: the port's kernel wrapper refuses an input that
    requires grad at the first forward, the reference's ``jax.grad``
    fails on its Pallas kernel."""
    value = dict(KERNEL_FLAGS)[flag]
    cfg, jcfg = _cfgs(arch, **{flag: value})
    nb = _batch(cfg.vocab_size)
    jb = jax_build(jcfg)
    with pytest.raises(Exception):                 # the error's type varies
        jax.grad(lambda p: jb.loss(p, jax.tree.map(jnp.asarray, nb))[0])(
            _ref_params(arch))
    state = train_state_from_numpy(
        {"params": _ref_params(arch),
         "opt": jax.tree.map(np.asarray, jax_adamw.init_opt_state(
             _ref_params(arch)))}, cfg, device=CPU)
    with pytest.raises(NotImplementedError, match="no VJP"):
        make_train_step(cfg)(state, _torch_batch(nb))


# ---------------------------------------------------------------------------
# the kernel guard
# ---------------------------------------------------------------------------

def _wrapper_calls():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.grouped_matmul.ops import (
        bucket_matmul, grouped_matmul)
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_verify_attention)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    def t(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=torch.Generator().manual_seed(0)
                           ).to(dtype)
    i32 = dict(dtype=torch.int32)
    tables = torch.tensor([[1, 2]], **i32)
    return {
        "flash_attention": (flash_attention, lambda g: (
            t(1, 8, 4, 16).requires_grad_(g), t(1, 8, 2, 16), t(1, 8, 2, 16))),
        "paged_decode_attention": (paged_decode_attention, lambda g: (
            t(1, 4, 16).requires_grad_(g), t(3, 4, 2, 16), t(3, 4, 2, 16),
            tables, torch.tensor([5], **i32))),
        "paged_verify_attention": (paged_verify_attention, lambda g: (
            t(1, 2, 4, 16), t(3, 4, 2, 16).requires_grad_(g), t(3, 4, 2, 16),
            tables, torch.tensor([3], **i32))),
        "decode_attention": (decode_attention, lambda g: (
            t(1, 4, 16), t(1, 8, 2, 16), t(1, 8, 2, 16).requires_grad_(g),
            torch.tensor([5], **i32))),
        "rmsnorm_fused": (rmsnorm_fused, lambda g: (
            t(3, 32), t(32).requires_grad_(g))),
        "grouped_matmul": (grouped_matmul, lambda g: (
            t(8, 16), t(2, 16, 8).requires_grad_(g),
            torch.tensor([3, 5], **i32))),
        "bucket_matmul": (bucket_matmul, lambda g: (
            t(2, 4, 16).requires_grad_(g), t(2, 16, 8))),
        "ssd_scan": (ssd_scan, lambda g: (
            t(1, 8, 2, 4).requires_grad_(g), t(1, 8, 2).abs(), -t(2).abs(),
            t(1, 8, 1, 4), t(1, 8, 1, 4))),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_every_kernel_wrapper_refuses_an_input_that_requires_grad(name):
    """The guard raises before dispatch, naming the kernel and the missing
    VJP; without grad (no input requiring it, or under ``no_grad``) the
    wrapper runs as before (its plain version on the CPU)."""
    fn, make = _wrapper_calls()[name]
    with pytest.raises(NotImplementedError, match=f"{name}: .*no VJP"):
        fn(*make(True))
    fn(*make(False))
    with torch.no_grad():
        fn(*make(True))


def test_serve_streams_unchanged_with_the_guard(monkeypatch):
    """Serving on the kernel flags with grad mode ON (frozen parameters)
    passes the guard, and every stream equals the run with the guard taken
    out (the tree before it)."""
    from repro_torch.kernels import _build
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"),
                              **dict(KERNEL_FLAGS))
    kw = dict(n_requests=4, slots=2, max_len=64, device=CPU)
    assert torch.is_grad_enabled()
    guarded = serve_direct(cfg, **kw)
    monkeypatch.setattr(_build, "refuse_grad", lambda *a: None)
    bare = serve_direct(cfg, **kw)
    assert guarded["completed"] == bare["completed"] == 4
    assert guarded["streams"] == bare["streams"]


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _step_port(state, cfg, i, oc):
    nb = SyntheticLM(SyntheticConfig(cfg.vocab_size, S, B)).batch_at(i)
    return make_train_step(cfg, oc)(state, to_device(nb, CPU))


def test_port_checkpoint_restores_in_the_reference_and_steps_alike(tmp_path):
    """A port checkpoint after one step restores with
    ``repro.ckpt.checkpoint.restore`` into the reference's train state
    (which checks every leaf's shape and dtype, in JAX's leaf order), with
    the port's values; the reference's next step from it matches the
    port's next step."""
    arch = "smollm-360m"
    cfg, jcfg = _cfgs(arch)
    oc = adamw.OptimConfig(warmup_steps=2, total_steps=20)
    state = init_train_state(cfg, 3, CPU)
    state, _ = _step_port(state, cfg, 0, oc)
    ck.save(str(tmp_path), 1, state_tree(state))
    like = jax.eval_shape(lambda: _jax_state(jcfg))
    jstate = jax_ck.restore(str(tmp_path), 1, like)
    mine = train_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(mine)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    nb = SyntheticLM(SyntheticConfig(cfg.vocab_size, S, B)).batch_at(1)
    _, jm = jax.jit(jax_make_step(jcfg, oc))(jstate,
                                             jax.tree.map(jnp.asarray, nb))
    _, m = _step_port(state, cfg, 1, oc)
    assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_TOL
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-2)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A reference checkpoint (its train state after one step) restores
    into the port's state leaf for leaf, and the port trains on from it."""
    arch = "mamba2-370m"
    cfg, jcfg = _cfgs(arch)
    oc = adamw.OptimConfig(warmup_steps=2, total_steps=20)
    nb = SyntheticLM(SyntheticConfig(cfg.vocab_size, S, B)).batch_at(0)
    jstate, _ = jax.jit(jax_make_step(jcfg, oc))(
        _jax_state(jcfg), jax.tree.map(jnp.asarray, nb))
    jax_ck.save(str(tmp_path), 1, jstate)
    state = init_train_state(cfg, 5, CPU)
    restored = ck.restore(str(tmp_path), 1, state_tree(state))
    load_train_state(state, restored)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jstate)),
                    jax.tree.leaves(train_state_to_numpy(state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert state["opt"]["step"].dtype == torch.int32
    assert state["params"].embed.requires_grad
    _, m = _step_port(state, cfg, 1, oc)
    assert np.isfinite(float(m["loss"]))


def test_checkpoint_leaf_order_is_jaxs(tmp_path):
    """``opt`` before ``params``; ``m``, ``step``, ``v`` inside ``opt``; a
    bf16 leaf is written in the reference's numpy bf16 and restores bitwise
    (it comes back from ``np.load`` as 2-byte void)."""
    import ml_dtypes
    t = {"params": {"b": torch.ones(2), "a": torch.zeros(3)},
         "opt": {"v": torch.full((2,), 2.0), "step": torch.tensor(7, dtype=torch.int32),
                 "m": torch.full((4,), 4.0)},
         "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    ck.save(str(tmp_path), 1, t)
    d = tmp_path / "step_1"
    shapes = [np.load(d / f"leaf_{i}.npy").shape for i in range(6)]
    assert shapes == [(2,), (4,), (), (2,), (3,), (2,)]
    raw = np.load(d / "leaf_0.npy")
    assert raw.dtype.itemsize == 2
    assert np.array_equal(raw.view(ml_dtypes.bfloat16).astype(np.float32),
                          [1.5, -2.25])
    back = ck.restore(str(tmp_path), 1, t)
    for a, b in zip(tree.leaves(back), tree.leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a train state holding its step's graph (under GRAPH_KEY, on the
    # card) checkpoints, restores and state_trees as one without it
    cfg, jcfg = _cfgs("smollm-360m")
    state = init_train_state(cfg, 0, CPU)
    state[GRAPH_KEY] = held = ("a held graph",)
    assert set(state_tree(state)) == {"params", "opt"}
    leaves = tree.leaves(state_tree(state))
    ck.save(str(tmp_path / "state"), 1, state_tree(state))
    like = jax.eval_shape(lambda: _jax_state(jcfg))
    jleaves = jax.tree.leaves(jax_ck.restore(str(tmp_path / "state"), 1,
                                             like))
    assert len(jleaves) == len(leaves)
    for a, b in zip(jleaves, leaves):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    ref = [t.detach().clone() for t in leaves]
    with torch.no_grad():
        for t in leaves:
            t.zero_()
    load_train_state(state, ck.restore(str(tmp_path / "state"), 1,
                                       state_tree(state)))
    assert state[GRAPH_KEY] is held
    for a, b in zip(tree.leaves(state_tree(state)), ref, strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# durability on torch trees (mirrors tests/test_durability.py)
# ---------------------------------------------------------------------------

def _tree(s=0):
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) + s,
            "b": torch.ones(3) * (s + 1)}


def _crash_after_retire(monkeypatch):
    real_rename = os.rename

    def crash(src, dst):
        real_rename(src, dst)
        if ck._RETIRED_PREFIX in os.path.basename(dst):
            raise RuntimeError("injected crash mid-overwrite")
    monkeypatch.setattr(os, "rename", crash)
    return real_rename


def test_ckpt_overwrite_crash_window_recovers(tmp_path, monkeypatch):
    """A crash between retiring the old ``step_N`` and renaming the new one
    in leaves the OLD checkpoint restorable once the retired dir is past
    the grace window."""
    d = str(tmp_path)
    ck.save(d, 1, _tree(1))
    ck.save(d, 2, _tree(2))
    real = _crash_after_retire(monkeypatch)
    with pytest.raises(RuntimeError, match="injected crash"):
        ck.save(d, 2, _tree(99))
    monkeypatch.setattr(os, "rename", real)
    (retired,) = [f for f in os.listdir(d) if f.startswith(ck._RETIRED_PREFIX)]
    parts = retired[len(ck._RETIRED_PREFIX):].split("_")
    parts[1] = str(int(parts[1]) - 60_000)
    os.rename(os.path.join(d, retired),
              os.path.join(d, ck._RETIRED_PREFIX + "_".join(parts)))
    assert ck.latest_step(d) == 2
    got = ck.restore(d, 2, _tree())
    for a, b in zip(tree.leaves(got), tree.leaves(_tree(2))):
        assert torch.equal(a, b)
    assert not [f for f in os.listdir(d) if f.startswith(ck._RETIRED_PREFIX)]
    ck.save(d, 2, _tree(7))
    assert ck.latest_step(d) == 2


def test_ckpt_fresh_retired_dir_is_left_for_its_writer(tmp_path, monkeypatch):
    d = str(tmp_path)
    ck.save(d, 1, _tree(1))
    ck.save(d, 2, _tree(2))
    real = _crash_after_retire(monkeypatch)
    with pytest.raises(RuntimeError):
        ck.save(d, 2, _tree(99))
    monkeypatch.setattr(os, "rename", real)
    assert ck.latest_step(d) == 1
    ck.restore(d, 1, _tree())


def test_ckpt_retired_leftover_is_garbage_collected(tmp_path):
    d = str(tmp_path)
    ck.save(d, 3, _tree(3))
    os.makedirs(os.path.join(d, f"{ck._RETIRED_PREFIX}3_999_999"))
    assert ck.latest_step(d) == 3
    assert not [f for f in os.listdir(d) if f.startswith(ck._RETIRED_PREFIX)]


def test_ckpt_restore_dtype_mismatch_raises_unless_cast(tmp_path):
    d = str(tmp_path)
    ck.save(d, 1, {"w": torch.ones((2, 2))})
    like = {"w": torch.empty((2, 2), dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="dtype"):
        ck.restore(d, 1, like)
    got = ck.restore(d, 1, like, cast=True)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.ones((2, 2)))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(d, 1, {"w": torch.empty((3, 2))})


def test_ckpt_keeps_the_last_k_and_async_snapshots(tmp_path):
    """keep-last-k prunes older steps; an async save snapshots the tree
    when called, so a later in-place update does not reach the file."""
    d = str(tmp_path)
    for s in range(1, 6):
        ck.save(d, s, _tree(s), keep=2)
    assert sorted(ck.all_steps(d)) == [4, 5] and ck.latest_step(d) == 5
    w = ck.AsyncCheckpointer(d, keep=3)
    t = _tree(10)
    w.save(6, t)
    t["w"].add_(100.0)
    w.wait()
    got = ck.restore(d, 6, _tree())
    assert torch.equal(got["w"], _tree(10)["w"])


# ---------------------------------------------------------------------------
# the train payload through pilots (mirrors tests/test_pilot_system.py)
# ---------------------------------------------------------------------------

def test_checkpoint_resume_across_pilots(tmp_path):
    """Train payload checkpoints; after a re-queue the successor resumes
    from the last step instead of starting over."""
    repo = TaskRepo(lease_ttl=60.0)
    sim = ClusterSim(repo=repo, device=CPU)
    ckd = str(tmp_path / "ck")
    resume = {"ckpt_dir": ckd, "ckpt_every": 2}
    tid = repo.submit(PayloadImage("smollm-360m", "smoke", "train"),
                      n_steps=4, resume=resume)
    (s,) = sim.provision(1)
    sim.spawn_pilot(s, PilotConfig(max_payloads=2, idle_grace=1.0))
    assert sim.run_until_drained(timeout=300.0)
    sim.join_all(30.0)
    first = repo.result(tid)
    assert first.exitcode == 0 and first.telemetry["steps"] == 4
    assert first.telemetry["step_graph"] is False      # the CPU: eager
    assert np.isfinite(first.telemetry["last_loss"])
    assert ck.latest_step(ckd) == 4
    # the reference restores the port's payload checkpoint too
    _, jcfg = _cfgs("smollm-360m")
    jax_ck.restore(ckd, 4, jax.eval_shape(lambda: _jax_state(jcfg)))
    tid2 = repo.submit(PayloadImage("smollm-360m", "smoke", "train"),
                       n_steps=4, resume=resume)
    (s2,) = sim.provision(1)
    sim.spawn_pilot(s2, PilotConfig(max_payloads=2, idle_grace=1.0))
    assert sim.run_until_drained(timeout=300.0)
    sim.join_all(30.0)
    r2 = repo.result(tid2)
    assert r2.telemetry.get("resumed_from") == 4 and r2.telemetry["steps"] == 0


def test_node_failure_resumes_from_the_last_checkpoint(tmp_path):
    """`train_via_pilots` with a node failure once step 2's checkpoint is
    on disk: a replacement pilot resumes from the last checkpoint the
    killed payload wrote, runs the remaining steps, and ends at the loss
    of an uninterrupted run of the same image (the CPU is deterministic)."""
    ckd = str(tmp_path / "ck")
    out = train_via_pilots("smollm-360m", True, 6, ckpt=ckd, device=CPU,
                           ckpt_every=2, fail_after_ckpt=2)
    res, fail = out["result"], out["failure"]
    assert out["drained"] and res is not None and res.exitcode == 0
    assert res.pilot_id != fail["pilot"] and fail["ckpt_step"] >= 2
    assert res.telemetry["resumed_from"] == fail["ckpt_step"]
    assert res.telemetry["steps"] == 6 - fail["ckpt_step"]
    assert fail["step_graph"] is False and res.telemetry["step_graph"] is False
    whole = train_via_pilots("smollm-360m", True, 6,
                             ckpt=str(tmp_path / "ck2"), device=CPU)
    assert whole["result"].telemetry["last_loss"] == res.telemetry["last_loss"]


def test_train_direct_loss_falls():
    cfg, _ = _cfgs("smollm-360m")
    out = train_direct(cfg, 12, 2, 32, device=CPU)
    losses = out["losses"]
    assert len(losses) == len(out["step_seconds"]) == 12
    assert out["step_graph"] is False                  # the CPU: eager
    assert out["capture_s"] == out["step_seconds"][0]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
