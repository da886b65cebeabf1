"""The port's whisper-small encoder-decoder against the JAX package:
cross-attention, the encoder, the decoder's prefill (logits, self and
cross caches) and decode steps, the loss and its gradient, the bridge, the
dense decode state, and the images that carry it (the engine refuses it,
as the reference's fails at its first admission).

Inputs are made with numpy from a seed and handed to both packages; the
parameters are the reference's own (``init_encdec_params`` with a
``jax.random`` key), bridged.  The port runs the serve entry's kernel
flags, whose wrappers run their plain versions on CPU tensors (flash at
``causal=False`` for the encoder and the cross-attention, the dense decode
kernel for the decoder's self-attention); the JAX side runs its plain
path.  The loss runs the plain paths on both sides, as training does.

Tolerances, and why:

* Layer outputs and logits: rtol = atol = 1e-2, tests/test_torch_model.py's
  (bf16 activations rounded at the same points, summed in other orders).
  Caches and the encoder's output, bf16 values up to |x| ~ 4 (after a
  LayerNorm): rtol = atol = 2e-2 (one bf16 ulp at |x| ~ 4),
  tests/test_torch_archs.py's ``POOL_TOL``.
* The loss: 2e-3; every gradient leaf ||g - g_ref|| / ||g_ref|| < 5e-3 at
  f32 compute, tests/test_torch_train.py's, but those reached only through
  the cross-attention's scores (``SCORE_LEAVES``), < 1e-2: the bf16
  operands of the attention make them noisy, and the reference's own
  gradient of them moves by 1.1-2.4 % when its attention chunk changes.
* The bridge's round trip: exact.
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
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models.api import build_model as jax_build
from repro.models.api import init_decode_state as jax_state
from repro_torch import tree
from repro_torch.bridge import (
    params_from_numpy, params_to_numpy, train_state_from_numpy,
    train_state_to_numpy)
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.arena import SharedArena
from repro_torch.core.images import ExecutableRegistry, PayloadImage
from repro_torch.core.proctable import ProcessTable
from repro_torch.core.wrapper import run_wrapper
from repro_torch.launch.steps import init_train_state
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.serving.engine import ServeEngine

ARCH = "whisper-small"
KERNELS = dict(attn_impl="pallas", norm_impl="pallas")
TOL = dict(rtol=1e-2, atol=1e-2)
POOL_TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_TOL = 2e-3
GRAD_TOL = 5e-3
# the leaves whose gradient reaches them only through the cross-attention's
# scores: bf16 rounding of q, k and p dominates them (the reference's own
# gradient moves 1.1 % (wk), 1.4 % (wq) and 2.4 % (the norm's bias) when
# its attention chunk goes from 64 to 8 keys)
SCORE_LEAVES = ("['cross_attn']['wq']", "['cross_attn']['wk']",
                "['cross_norm']")
SCORE_GRAD_TOL = 1e-2
CPU = "cpu"
B, S, MAX_LEN, STEPS = 2, 6, 32, 4


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values as a torch tensor and a jax array."""
    t = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    t = t.to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _cfgs(**kw):
    """(port cfg on the kernel flags, reference cfg on its plain path)."""
    return (dataclasses.replace(get_smoke_config(ARCH), **{**KERNELS, **kw}),
            dataclasses.replace(jax_smoke(ARCH), **kw))


@pytest.fixture(scope="module")
def model():
    """(cfg, jcfg, the reference's f32 tree (numpy), port params (bf16
    serve layout), jax params)."""
    cfg, jcfg = _cfgs()
    t = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(0)))
    return (cfg, jcfg, t, params_from_numpy(t, cfg, device=CPU),
            jax.tree.map(jnp.asarray, t))


@pytest.fixture(scope="module")
def inputs(model):
    """Frames (B, F, D) bf16 at the stub's scale, a prompt (B, S) and
    ``STEPS`` teacher-forced tokens, as torch and jax."""
    cfg = model[0]
    rng = np.random.default_rng(3)
    frames, jframes = _bf16_pair(rng, (B, cfg.frontend_tokens, cfg.d_model),
                                 0.02)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    return frames, jframes, toks, forced


@pytest.fixture(scope="module")
def reference(model, inputs):
    """The reference's encoder output, prefill (logits and caches) and the
    decode steps' logits from a ``MAX_LEN`` state built from the prefill's
    caches, computed once."""
    _, jcfg, _, _, jparams = model
    _, jframes, toks, forced = inputs
    enc = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(jparams, jframes)
    jb = jax_build(jcfg)
    logits, cache = jax.jit(jb.prefill)(
        jparams, {"tokens": jnp.asarray(toks), "frontend": jframes})
    state = jax_state(jcfg, B, MAX_LEN, kv="dense")
    state["cache"] = _install(state["cache"], cache, jnp)
    state["pos"] = jnp.full((B,), S, jnp.int32)
    decode = jax.jit(jb.decode)
    steps = []
    for t in range(STEPS):
        state = {**state, "token": jnp.asarray(forced[t])}
        lg, state = decode(jparams, state)
        steps.append(_f(lg[:, 0]))
    return {"encode": _f(enc), "logits": _f(logits), "cache": cache,
            "decode": np.stack(steps), "state": state}


def _install(dst, src, xp):
    """The prefill's caches into a decode state's: the self K/V into the
    first rows, the cross K/V whole (the glue a caller of the bundle
    writes; the reference has none)."""
    if xp is jnp:
        T = src["self"]["k"].shape[2]
        return {"self": {k: v.at[:, :, :T].set(src["self"][k])
                         for k, v in dst["self"].items()},
                "cross": dict(src["cross"])}
    T = src["self"]["k"].shape[2]
    for k in ("k", "v"):
        dst["self"][k][:, :, :T] = src["self"][k]
        dst["cross"][k].copy_(src["cross"][k])
    return dst


# ---------------------------------------------------------------------------
# config, cross-attention, encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_copies_the_reference(smoke):
    mine = (get_smoke_config if smoke else get_config)(ARCH)
    ref = (jax_smoke if smoke else jax_config)(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    if not smoke:
        assert (mine.encoder_layers, mine.num_layers, mine.d_model,
                mine.num_heads, mine.num_kv_heads, mine.frontend_tokens,
                mine.norm, mine.mlp_gated, mine.tie_embeddings) == (
            12, 12, 768, 12, 12, 1500, "layernorm", False, True)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("Sq", [5, 32])
def test_cross_attention_forward_matches_jax(impl, Sq):
    """``attention_forward(kv=src)``: K and V projected from the source (32
    frames) with no RoPE, every query against every key; at S != T and
    S = T, through flash's plain version and the chunked path."""
    cfg, jcfg = _cfgs(attn_impl=impl)
    jp = jattn.init_attention(jax.random.key(1), jcfg)
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16)
         for k, v in jax.tree.map(np.asarray, jp).items()}
    rng = np.random.default_rng(Sq)
    x, jx = _bf16_pair(rng, (2, Sq, cfg.d_model))
    src, jsrc = _bf16_pair(rng, (2, 32, cfg.d_model))
    out = attn.attention_forward(x, p, cfg, rope_cos=None, rope_sin=None,
                                 causal=False, kv=src)
    ref = jattn.attention_forward(jx, jp, dataclasses.replace(
        jcfg, attn_impl="chunked"), rope_cos=None, rope_sin=None,
        causal=False, kv=jsrc)
    assert out.shape == (2, Sq, cfg.d_model)
    np.testing.assert_allclose(_f(out), _f(ref), **TOL)


def test_sinusoidal_matches_jax():
    got = encdec._sinusoidal(40, 64, CPU)
    np.testing.assert_allclose(_f(got), _f(jencdec._sinusoidal(40, 64)),
                               rtol=1e-5, atol=1e-5)


def test_encode_matches_jax(model, inputs, reference):
    """The encoder: sinusoidal positions, non-causal self-attention over
    the frames (flash's plain version), LayerNorm, GELU MLP."""
    cfg, _, _, params, _ = model
    with torch.no_grad():
        got = encdec.encode(params, cfg, inputs[0])
    np.testing.assert_allclose(_f(got), reference["encode"], **POOL_TOL)


# ---------------------------------------------------------------------------
# prefill, decode
# ---------------------------------------------------------------------------

def _port_prefill(model, inputs):
    cfg, _, _, params, _ = model
    frames, _, toks, _ = inputs
    with torch.no_grad():
        return build_model(cfg).prefill(
            params, {"tokens": torch.from_numpy(toks), "frontend": frames})


def test_encdec_prefill_matches_jax(model, inputs, reference):
    """``encdec_prefill``: the last logits, the decoder's self K/V (L, B,
    S, K, Dh) and the cross K/V (L, B, F, K, Dh) of the encoder output."""
    logits, cache = _port_prefill(model, inputs)
    np.testing.assert_allclose(_f(logits), reference["logits"], **TOL)
    for w in ("self", "cross"):
        for k in ("k", "v"):
            want = _f(reference["cache"][w][k])
            assert tuple(cache[w][k].shape) == want.shape, (w, k)
            np.testing.assert_allclose(_f(cache[w][k]), want, **POOL_TOL)


def test_encdec_decode_matches_jax_and_writes_in_place(model, inputs,
                                                       reference):
    """``STEPS`` teacher-forced ``encdec_decode`` steps from a ``MAX_LEN``
    dense state built from the prefill's caches: every logit, the self
    cache written in place at each row's position (the cross K/V read,
    never written), and the positions."""
    cfg, _, _, params, _ = model
    _, cache = _port_prefill(model, inputs)
    bundle = build_model(cfg)
    state = init_decode_state(cfg, B, MAX_LEN, kv="dense", device=CPU)
    _install(state["cache"], cache, torch)
    state["pos"][:] = S
    self_k = state["cache"]["self"]["k"]
    cross = {k: v.clone() for k, v in state["cache"]["cross"].items()}
    got = []
    with torch.no_grad():
        for t in range(STEPS):
            state["token"] = torch.from_numpy(inputs[3][t].copy())
            lg, state = bundle.decode(params, state)
            got.append(_f(lg[:, 0]))
    np.testing.assert_allclose(np.stack(got), reference["decode"], **TOL)
    assert state["cache"]["self"]["k"] is self_k
    for k in ("k", "v"):
        assert torch.equal(state["cache"]["cross"][k], cross[k])
        np.testing.assert_allclose(
            _f(state["cache"]["self"][k]),
            _f(reference["state"]["cache"]["self"][k]), **POOL_TOL)
    assert state["pos"].tolist() == [S + STEPS] * B
    assert not state["cache"]["self"]["k"][:, :, S + STEPS:].any()


def test_init_decode_state_is_dense_only():
    """An enc-dec state holds the self cache at ``max_len`` and the cross
    K/V at ``frontend_tokens``, as the reference's; ``kv="paged"`` raises
    ``ValueError`` on both sides."""
    cfg, jcfg = _cfgs()
    st = init_decode_state(cfg, 3, 40, kv="dense", device=CPU)
    jst = jax_state(jcfg, 3, 40, kv="dense")
    for w in ("self", "cross"):
        for k in ("k", "v"):
            assert tuple(st["cache"][w][k].shape) == \
                tuple(jst["cache"][w][k].shape)
    with pytest.raises(ValueError, match="enc-dec"):
        init_decode_state(cfg, 3, 48, kv="paged", device=CPU)
    with pytest.raises(ValueError, match="enc-dec"):
        jax_state(jcfg, 3, 48, kv="paged")
    bundle = build_model(cfg)
    assert bundle.verify is None and bundle.prefill_chunk is None


# ---------------------------------------------------------------------------
# loss and gradient
# ---------------------------------------------------------------------------

def _train_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size,
                                    (2, 24)).astype(np.int32),
            "frontend": (rng.normal(size=(2, cfg.frontend_tokens, cfg.d_model))
                         * 0.02).astype(np.float32)}


def test_encdec_loss_and_every_gradient_leaf_match_jax(model):
    """``bundle.loss`` at f32 compute on f32 master weights: the loss and
    every leaf of its gradient against ``jax.grad`` of the reference's (the
    encoder, both attentions and the tied embedding included); each layer
    runs under `_remat`."""
    _, _, t, _, _ = model
    cfg, jcfg = _cfgs(attn_impl="chunked", norm_impl="jnp")
    nb = _train_batch(cfg)
    jb = jax_build(jcfg, compute=jnp.float32)
    jnb = jax.tree.map(jnp.asarray, nb)
    (jloss, jm), grads = jax.jit(jax.value_and_grad(
        lambda p: jb.loss(p, jnb), has_aux=True))(t)
    params = params_from_numpy(t, cfg, device=CPU,
                               matrix_dtype=torch.float32).requires_grad_(True)
    loss, m = build_model(cfg, compute=torch.float32).loss(
        params, {k: torch.from_numpy(v) for k, v in nb.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_TOL
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, grads))
    mine = tree.leaves(params.live())
    assert len(mine) == len(want)
    names = set()
    for (path, g), p in zip(want, mine):
        name = jax.tree_util.keystr(path)
        names.add(name.split("']")[0].split("['")[1])
        got = p.grad.numpy()
        assert got.shape == g.shape and np.isfinite(got).all(), name
        if np.abs(g).max() == 0:
            assert np.abs(got).max() == 0, name
            continue
        rel = float(np.linalg.norm(got - g) / np.linalg.norm(g))
        tol = (SCORE_GRAD_TOL if any(k in name for k in SCORE_LEAVES)
               else GRAD_TOL)
        assert rel < tol, (name, rel)
    assert {"embed", "enc_layers", "enc_norm", "dec_layers",
            "final_norm"} == names


# ---------------------------------------------------------------------------
# bridge, images, engine
# ---------------------------------------------------------------------------

def test_bridge_round_trip(model):
    """The reference's tree onto :class:`EncDecParams` and back, exactly at
    f32; LayerNorms' ``scale`` and ``bias`` stay f32 in the serve layout;
    a train state maps both ways."""
    cfg, jcfg, t, params, _ = model
    assert isinstance(params, encdec.EncDecParams)
    assert params.enc_layers["attn_norm"]["bias"].dtype == torch.float32
    assert params.dec_layers["cross_attn"]["wk"].dtype == torch.bfloat16
    back = params_to_numpy(params_from_numpy(t, cfg, device=CPU,
                                             matrix_dtype=torch.float32))
    flat, want = tree.leaves(back), jax.tree.leaves(t)
    assert len(flat) == len(want)
    for a, b in zip(flat, want):
        np.testing.assert_array_equal(a, b)
    state = train_state_to_numpy(init_train_state(cfg, 0, CPU))
    again = train_state_to_numpy(train_state_from_numpy(state, cfg, CPU))
    for a, b in zip(tree.leaves(again), tree.leaves(state)):
        np.testing.assert_array_equal(a, b)


def test_engine_refuses_an_encdec_config(model):
    """The serve engine refuses whisper at construction, naming why (the
    reference fails at its first admission with a KeyError)."""
    cfg, _, _, params, _ = model
    with pytest.raises(ValueError, match="enc-dec archs do not run"):
        ServeEngine(cfg, params, slots=2, max_len=32, device=CPU)


def _run(tmp_path, exe, spec):
    arena = SharedArena(str(tmp_path / "a"))
    code = run_wrapper(arena, ProcessTable(), exe, spec)
    return code, arena.read_exit()["telemetry"]


def test_prefill_and_decode_images(tmp_path):
    """whisper's "prefill" image (frames and a prompt; its batch carries
    ``frontend``) and "decode" image (a dense state) run through the
    payload wrapper with exit code 0; its "train" image fails on the
    batch's missing ``frontend``, as the reference's does."""
    reg = ExecutableRegistry()
    pre = reg.pull(PayloadImage(ARCH, "smoke", "prefill"), CPU)
    params, batch = pre.make_inputs(0)
    cfg = get_smoke_config(ARCH)
    assert tuple(batch["frontend"].shape) == (2, cfg.frontend_tokens,
                                              cfg.d_model)
    assert batch["frontend"].dtype == torch.bfloat16
    assert tuple(batch["tokens"].shape) == (2, 64)
    code, tel = _run(tmp_path / "p", pre, {})
    assert code == 0 and tel["steps"] == 1, tel
    dec = reg.pull(PayloadImage(ARCH, "smoke", "decode"), CPU)
    code, tel = _run(tmp_path / "d", dec, {"n_steps": 3})
    assert code == 0 and tel["steps"] == 3, tel
    train = reg.pull(PayloadImage(ARCH, "smoke", "train"), CPU)
    code, tel = _run(tmp_path / "t", train, {"n_steps": 1})
    assert code == 1 and "frontend" in tel["error"], tel
