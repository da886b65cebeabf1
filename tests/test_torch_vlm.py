"""The port's llava-next-mistral-7b VLM stub against the JAX package: the
frontend's stub patch embeddings prepended in ``lm_prefill`` (RoPE and the
cache over F + S positions) and in ``lm_loss`` (scored over the token
positions only, with its gradient), the prefill image's batch, and the
engine, which serves text only, as the reference's engine does.

Inputs are made with numpy from a seed and handed to both packages; the
parameters are the reference's own (key 0), bridged.  The port runs the
serve entry's kernel flags (flash and RMSNorm), whose wrappers run their
plain versions on CPU tensors; the JAX side runs its plain path.  The loss
runs the plain paths on both sides, as training does.

Tolerances, and why:

* Logits: rtol = atol = 1e-2, tests/test_torch_model.py's (bf16
  activations rounded at the same points, summed in other orders); K/V
  caches 2e-2 (one bf16 ulp at |x| ~ 4), tests/test_torch_archs.py's.
* The loss 2e-3; every gradient leaf ||g - g_ref|| / ||g_ref|| < 5e-3 at
  f32 compute: tests/test_torch_train.py's.
* Engine streams against the reference engine's: equal up to each
  request's first position whose JAX top-2 logit margin is below 2e-2,
  tests/test_torch_engine.py's rule.  Inside the port: bitwise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.configs.base import get_smoke_config as jax_smoke
from repro.models.api import build_model as jax_build
from repro.serving.engine import ServeEngine as JaxEngine
from repro.serving.engine import make_engine_step as jax_make_step
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.arena import SharedArena
from repro_torch.core.images import ExecutableRegistry, PayloadImage
from repro_torch.core.proctable import ProcessTable
from repro_torch.core.wrapper import run_wrapper
from repro_torch.launch.serve import make_trace
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServeEngine

ARCH = "llava-next-mistral-7b"
KERNELS = dict(attn_impl="pallas", norm_impl="pallas")
PLAIN = dict(attn_impl="chunked", norm_impl="jnp")
TOL = dict(rtol=1e-2, atol=1e-2)
POOL_TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_TOL = 2e-3
GRAD_TOL = 5e-3
MARGIN = 2e-2
CPU = "cpu"


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(port=KERNELS):
    return (dataclasses.replace(get_smoke_config(ARCH), **port),
            dataclasses.replace(jax_smoke(ARCH), **PLAIN))


@pytest.fixture(scope="module")
def model():
    """(cfg, jcfg, the reference's f32 tree (numpy), port params (bf16
    serve layout), jax params)."""
    cfg, jcfg = _cfgs()
    t = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(0)))
    return (cfg, jcfg, t, params_from_numpy(t, cfg, device=CPU),
            jax.tree.map(jnp.asarray, t))


def _patches(cfg, B, seed=5):
    """Stub patch embeddings (B, F, D) at the image's scale (normal x
    0.02), bf16, as torch and jax."""
    a = (np.random.default_rng(seed).normal(
        size=(B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_copies_the_reference(smoke):
    mine = (get_smoke_config if smoke else get_config)(ARCH)
    ref = (jax_smoke if smoke else jax_config)(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    if not smoke:
        assert (mine.family, mine.frontend_tokens, mine.num_layers,
                mine.d_model, mine.num_heads, mine.num_kv_heads) == (
            "vlm", 576, 32, 4096, 32, 8)


def test_lm_prefill_with_extra_embeds_matches_jax(model):
    """``bundle.prefill`` of 2 rows of 20 text tokens with 16 patch
    embeddings prepended: the last logits and the K/V cache over all 36
    positions (RoPE over F + S)."""
    cfg, jcfg, _, params, jparams = model
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    patches, jpatches = _patches(cfg, 2)
    with torch.no_grad():
        logits, cache = build_model(cfg).prefill(
            params, {"tokens": torch.from_numpy(toks), "frontend": patches})
    jlogits, jcache = jax.jit(jax_build(jcfg).prefill)(
        jparams, {"tokens": jnp.asarray(toks), "frontend": jpatches})
    np.testing.assert_allclose(_f(logits), _f(jlogits), **TOL)
    for mine, ref in zip(cache, jcache):
        for k in ("k", "v"):
            assert tuple(mine[k].shape) == ref[k].shape
            assert mine[k].shape[2] == 20 + cfg.frontend_tokens
            np.testing.assert_allclose(_f(mine[k]), _f(ref[k]), **POOL_TOL)
    # the patches matter: text alone gives other logits
    with torch.no_grad():
        alone, text_cache = build_model(cfg).prefill(
            params, {"tokens": torch.from_numpy(toks)})
    assert not torch.equal(alone, logits)
    # text alone still allocates F + S positions, as the reference's does
    assert text_cache[0]["k"].shape[2] == 20 + cfg.frontend_tokens


def _train_batch(cfg):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size,
                                    (2, 24)).astype(np.int32),
            "frontend": (rng.normal(size=(2, cfg.frontend_tokens, cfg.d_model))
                         * 0.02).astype(np.float32)}


def test_lm_loss_over_token_positions_and_every_gradient_leaf(model):
    """``bundle.loss`` with a ``frontend`` batch at f32 compute on f32
    master weights, plain paths: the CE over the token positions only
    (``h[:, F:]``) and every leaf of its gradient against the
    reference's."""
    t = model[2]
    cfg, jcfg = _cfgs(port=PLAIN)
    nb = _train_batch(cfg)
    jb = jax_build(jcfg, compute=jnp.float32)
    jnb = jax.tree.map(jnp.asarray, nb)
    (jloss, jm), grads = jax.jit(jax.value_and_grad(
        lambda p: jb.loss(p, jnb), has_aux=True))(t)
    params = params_from_numpy(t, cfg, device=CPU,
                               matrix_dtype=torch.float32).requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    loss, m = build_model(cfg, compute=torch.float32).loss(params, batch)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_TOL
    assert abs(float(m["ce"].detach()) - float(jm["ce"])) < LOSS_TOL
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, grads))
    mine = tree.leaves(params.live())
    assert len(mine) == len(want)
    for (path, g), p in zip(want, mine):
        name = jax.tree_util.keystr(path)
        got = p.grad.numpy()
        assert got.shape == g.shape and np.isfinite(got).all(), name
        rel = float(np.linalg.norm(got - g) / np.linalg.norm(g))
        assert rel < GRAD_TOL, (name, rel)
    # the text-only loss differs: the patches reach the scored positions
    with torch.no_grad():
        text, _ = build_model(cfg, compute=torch.float32).loss(
            params, {k: v for k, v in batch.items() if k != "frontend"})
    assert abs(float(text) - float(loss.detach())) > 1e-6


def test_prefill_image_batch_carries_frontend(tmp_path):
    """The "prefill" image's batch holds the text length's tokens (the
    shape's sequence less the patches) and ``frontend`` (B, F, D) bf16 at
    scale 0.02; the payload runs with exit code 0."""
    exe = ExecutableRegistry().pull(PayloadImage(ARCH, "smoke", "prefill"),
                                    CPU)
    _, batch = exe.make_inputs(0)
    cfg = get_smoke_config(ARCH)
    assert tuple(batch["tokens"].shape) == (2, 64 - cfg.frontend_tokens)
    f = batch["frontend"]
    assert tuple(f.shape) == (2, cfg.frontend_tokens, cfg.d_model)
    assert f.dtype == torch.bfloat16 and 0.01 < float(f.float().std()) < 0.03
    arena = SharedArena(str(tmp_path / "a"))
    assert run_wrapper(arena, ProcessTable(), exe, {}) == 0


def _margin(row):
    top = np.sort(np.asarray(row, np.float32))[-2:]
    return float(top[1] - top[0])


def test_engine_serves_text_only_as_the_reference_engine(model):
    """A 6-request trace through both engines (2 slots, max_len 64, paged)
    on the same bridged weights, text only: streams equal up to the first
    position with a JAX top-2 margin below ``MARGIN``; the port's paged
    and dense streams bitwise equal, one transfer a step."""
    _, jcfg, t, _, jparams = model
    cfg = get_smoke_config(ARCH)
    params = params_from_numpy(t, cfg, device=CPU)
    trace = make_trace(cfg.vocab_size, 6, max_len=64, seed=0)
    port = ServeEngine(cfg, params, slots=2, max_len=64, device=CPU)
    port.run_trace(trace)
    assert port.kv == "paged" and port.d2h_transfers == port.steps
    dense = ServeEngine(cfg, params, slots=2, max_len=64, kv="dense",
                        device=CPU)
    dense.run_trace(trace)
    assert {r: q.tokens for r, q in dense.done.items()} == \
        {r: q.tokens for r, q in port.done.items()}

    jcfg = jax_smoke(ARCH)
    jb = jax_build(jcfg)
    base_step = jax_make_step(jb, 64)
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

    jeng = JaxEngine(jcfg, jparams, slots=2, max_len=64, bundle=jb,
                     step_fn=step_fn, prefill_fn=prefill_fn)
    holder["eng"] = jeng
    jeng.run_trace(trace)
    compared = 0
    for rid, jreq in jeng.done.items():
        mine = port.done[rid].tokens
        assert len(mine) == len(jreq.tokens) == len(margins[rid])
        n = next((j for j, m in enumerate(margins[rid]) if m < MARGIN),
                 len(mine))
        assert mine[:n] == jreq.tokens[:n], (rid, n)
        compared += n
    assert compared > 0


def test_chunked_admission_beside_a_decoding_slot_is_its_idle_run(model):
    """A request admitted chunk by chunk (text only) while another slot
    decodes gives its idle-engine stream bit for bit."""
    cfg, params = model[0], model[3]
    kw = dict(slots=2, max_len=64, prefill="chunked", prefill_chunk=16)
    solo = ServeEngine(cfg, params, device=CPU, **kw)
    solo.submit(Request(1, np.random.default_rng(1).integers(
        0, cfg.vocab_size, 30).astype(np.int32), 3))
    solo.run()
    eng = ServeEngine(cfg, params, device=CPU, **kw)
    for i, (n, m) in enumerate([(20, 12), (30, 3), (7, 4)]):
        eng.submit(Request(i, np.random.default_rng(i).integers(
            0, cfg.vocab_size, n).astype(np.int32), m))
    eng.run()
    assert eng.prefill_chunks >= 3
    assert [len(eng.done[i].tokens) for i in range(3)] == [13, 4, 5]
    assert eng.done[1].tokens == solo.done[1].tokens
    assert eng.block_leaks() == 0
