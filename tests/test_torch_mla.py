"""The port's multi-head latent attention (MLA) and minicpm3-4b against the
JAX package, and the reference's MLA invariants inside the port.

Inputs are made with numpy from a seed and handed to both packages; model
and layer parameters are the reference's own (``jax.random`` keys),
bridged, with ``q_norm`` and ``kv_norm`` moved off their zero init by f32
values no bf16 holds (so a bridge that rounded them would show).  Both
sides run the serve entry's kernel flags (``attn_impl="pallas"``,
``norm_impl="pallas"``) unless a test says otherwise: the JAX flash and
RMSNorm kernels in Pallas interpret mode, the port's wrappers on their
plain versions (CPU tensors).  MLA's decode, verify and chunk paths are
plain PyTorch on both sides (the reference has no kernel for them); the
loss runs the plain paths, as training does.

Tolerances, those of tests/test_torch_archs.py, and why:

* Latent cache writes: rtol = atol = 2e-2 (``POOL_TOL``, one bf16 ulp at
  |x| ~ 4: the rows are bf16 products and norms of the two libraries).
* Layer outputs and logits: rtol = atol = 1e-2 (bf16 activations rounded
  at the same points, summed in other orders).
* Chained chunks against the one-shot prefill, inside one package: the
  same 1e-2 (the chunk scores the latent with the absorbed weights, the
  one-shot prefill attends the expanded heads).
* The loss: 2e-3; each gradient leaf's ||g - g_ref|| / ||g_ref||: 5e-3 at
  f32 compute and 5e-2 at bf16 (tests/test_torch_train.py's).
* Inside the port: streams and paged-against-dense decode bitwise.
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
from repro.models import layers as jl
from repro.models.api import build_model as jax_build
from repro.models.api import init_decode_state as jax_state
from repro.serving.engine import _install_slot as jax_install
from repro.serving.engine import _install_slot_paged as jax_install_paged
from repro_torch import tree
from repro_torch.bridge import F32_LEAVES, params_from_numpy, params_to_numpy
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.images import ExecutableRegistry, PayloadImage
from repro_torch.launch.serve import expected_tokens, make_trace, serve_direct
from repro_torch.launch.train import train_direct
from repro_torch.models import attention as attn
from repro_torch.models import layers as tl
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.serving.engine import (
    Request, ServeEngine, _install_slot, _install_slot_paged)

ARCH = "minicpm3-4b"
KERNELS = dict(attn_impl="pallas", norm_impl="pallas")
PLAIN = dict(attn_impl="chunked", norm_impl="jnp")
TOL = dict(rtol=1e-2, atol=1e-2)
POOL_TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_TOL = 2e-3
GRAD_TOL = {"f32": 5e-3, "bf16": 5e-2}
CPU = "cpu"


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
    kw = {**KERNELS, **kw}
    return (dataclasses.replace(get_smoke_config(ARCH), **kw),
            dataclasses.replace(jax_smoke(ARCH), **kw))


def _nudge_norms(t, seed):
    """``t`` with every ``q_norm``/``kv_norm`` leaf moved by N(0, 0.1) f32
    noise (the init is zeros, which bf16 holds exactly)."""
    rng = np.random.default_rng(seed)

    def nudge(path, v):
        if jax.tree_util.keystr(path).endswith(("['q_norm']", "['kv_norm']")):
            return (np.asarray(v) + rng.normal(size=np.shape(v)) * 0.1
                    ).astype(np.float32)
        return np.asarray(v)
    return jax.tree_util.tree_map_with_path(nudge, t)


_TREE: list = []


def _ref_tree():
    """The reference's f32 parameters of the smoke config (numpy), from
    key 0, latent norms nudged."""
    if not _TREE:
        _, jcfg = _cfgs()
        _TREE.append(_nudge_norms(jax_build(jcfg).init(jax.random.key(0)), 0))
    return _TREE[0]


def _model(**kw):
    """(cfg, jcfg, port params (bf16 serve layout), jax params)."""
    cfg, jcfg = _cfgs(**kw)
    return (cfg, jcfg, params_from_numpy(_ref_tree(), cfg, device=CPU),
            jax.tree.map(jnp.asarray, _ref_tree()))


_JIT: dict = {}


def _jax_fn(name):
    """The reference bundle's jitted ``name`` on the kernel flags, built
    once for the file (its traces are shared between tests)."""
    if name not in _JIT:
        _JIT[name] = jax.jit(getattr(jax_build(_cfgs()[1]), name))
    return _JIT[name]


def _layer(jcfg, seed=1):
    """One MLA layer's reference parameters (jax, f32, norms nudged) and
    the port's (as the bridge stores them: bf16, latent norms f32)."""
    jp = _nudge_norms(jattn.init_attention(jax.random.key(seed), jcfg), seed)
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k in F32_LEAVES else torch.bfloat16)
        for k, v in jp.items()}
    return p, jax.tree.map(jnp.asarray, jp)


def _prompt(vocab, n, plen, seed):
    """A left-padded prompt of ``n`` tokens in a bucket of ``plen``."""
    toks = np.zeros((plen,), np.int32)
    toks[-n:] = np.random.default_rng(seed).integers(0, vocab, size=n)
    return toks


# ---------------------------------------------------------------------------
# config, bridge, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_copies_the_reference(smoke):
    mine = (get_smoke_config if smoke else get_config)(ARCH)
    ref = (jax_smoke if smoke else jax_config)(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    if not smoke:
        s = mine.mla
        assert (mine.num_layers, mine.d_model, mine.num_heads,
                mine.num_kv_heads, mine.d_ff, mine.vocab_size) == \
            (62, 2560, 40, 40, 6400, 73448)
        assert (s.q_lora_rank, s.kv_lora_rank, s.qk_nope_head_dim,
                s.qk_rope_head_dim, s.v_head_dim, s.qk_head_dim) == \
            (768, 256, 64, 32, 64, 96)


def test_latent_norms_are_bridged_in_f32():
    """``q_norm`` and ``kv_norm`` cross the bridge in f32, exactly, both
    ways (as the reference keeps and applies them)."""
    assert {"q_norm", "kv_norm"} <= set(F32_LEAVES)
    cfg, _ = _cfgs()
    params = params_from_numpy(_ref_tree(), cfg, device=CPU)
    mixer = params.layers[0]["mixer"]
    assert mixer["q_norm"].dtype == mixer["kv_norm"].dtype == torch.float32
    assert mixer["wkv_b"].dtype == torch.bfloat16
    back = params_to_numpy(params)
    for k in ("q_norm", "kv_norm"):
        want = _ref_tree()["layers"][0]["mixer"][k]
        assert (want.astype(np.float32) != want.astype(jnp.bfloat16)
                .astype(np.float32)).any()       # the nudge is not bf16
        np.testing.assert_array_equal(back["layers"][0]["mixer"][k], want)


def test_init_attention_has_the_reference_layout():
    """The port's MLA init: the reference's leaves and shapes, bf16
    matrices, f32 zero latent norms; the paged cache's latent pools and
    the dense rings as the reference shapes them."""
    cfg, jcfg = _cfgs()
    p = attn.init_attention(torch.Generator().manual_seed(0), cfg)
    jp = jattn.init_attention(jax.random.key(0), jcfg)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k in ("q_norm", "kv_norm"):
        assert p[k].dtype == torch.float32 and not p[k].any()
    assert p["wq_a"].dtype == torch.bfloat16
    for mine, ref in (
            (attn.init_kv_cache(cfg, 3, 64), jattn.init_kv_cache(jcfg, 3, 64)),
            (attn.init_kv_cache_paged(cfg, 3, 64, 13, 16),
             jattn.init_kv_cache_paged(jcfg, 3, 64, 13, 16))):
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in ref.items()}


# ---------------------------------------------------------------------------
# the layer: forward, prefill, decode (both layouts), verify
# ---------------------------------------------------------------------------

def _rope(cfg, S):
    cos, sin = tl.rope_table(torch.arange(S), attn.rope_dim(cfg),
                             cfg.rope_theta)
    jcos, jsin = jl.rope_table(jnp.arange(S), cfg.mla.qk_rope_head_dim,
                               cfg.rope_theta)
    return (cos, sin), (jcos, jsin)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_mla_forward_matches_jax(impl):
    """The train path's layer (`_mla_forward`, full expansion) on the plain
    attend and on the flash path."""
    cfg, jcfg = _cfgs(attn_impl=impl)
    assert attn.rope_dim(cfg) == cfg.mla.qk_rope_head_dim != cfg.head_dim
    p, jp = _layer(jcfg)
    x, jx = _bf16_pair(np.random.default_rng(0), (2, 20, cfg.d_model))
    (cos, sin), (jcos, jsin) = _rope(cfg, 20)
    out = attn.attention_forward(x, p, cfg, rope_cos=cos, rope_sin=sin)
    ref = jattn.attention_forward(jx, jp, jcfg, rope_cos=jcos, rope_sin=jsin)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 20, cfg.d_model)
    np.testing.assert_allclose(_f(out), _f(ref), **TOL)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_mla_prefill_matches_jax(impl):
    """`_mla_prefill`: the output and the latent rings it fills (padded
    past the prompt)."""
    cfg, jcfg = _cfgs(attn_impl=impl)
    p, jp = _layer(jcfg)
    x, jx = _bf16_pair(np.random.default_rng(1), (2, 20, cfg.d_model))
    (cos, sin), (jcos, jsin) = _rope(cfg, 20)
    out, cache = attn.attention_prefill(x, p, cfg, (cos, sin),
                                        attn.init_kv_cache(cfg, 2, 32))
    ref, jcache = jattn.attention_prefill(jx, jp, jcfg, (jcos, jsin),
                                          jattn.init_kv_cache(jcfg, 2, 32))
    np.testing.assert_allclose(_f(out), _f(ref), **TOL)
    assert set(cache) == set(jcache) == {"ckv", "krope"}
    for k in cache:
        assert cache[k].shape == jcache[k].shape and cache[k].dtype == \
            torch.bfloat16
        np.testing.assert_allclose(_f(cache[k]), _f(jcache[k]), **POOL_TOL)
        assert not cache[k][:, 20:].any()


def _latent_caches(cfg, jcfg, B=3, T=32, bs=16, seed=3):
    """Random dense latent rings (B, T, *) and the same rows scattered into
    permuted pool blocks, for both packages: (dense, paged, tables) each
    as (port, jax)."""
    rng = np.random.default_rng(seed)
    mb = T // bs
    nb = B * mb + 1
    perm = rng.permutation(np.arange(1, nb)).reshape(B, mb).astype(np.int32)
    dense, jdense, paged, jpaged = {}, {}, {}, {}
    for k, v in attn.init_kv_cache(cfg, B, T).items():
        t, j = _bf16_pair(rng, tuple(v.shape), 0.5)
        dense[k], jdense[k] = t, j
        pool = torch.zeros((nb, bs) + t.shape[2:], dtype=t.dtype)
        pool[torch.from_numpy(perm.reshape(-1)).long()] = t.reshape(
            (B * mb, bs) + t.shape[2:])
        paged[k + "p"] = pool
        jpaged[k + "p"] = jnp.asarray(pool.float().numpy(), jnp.bfloat16)
    return ((dense, jdense), (paged, jpaged),
            (torch.from_numpy(perm), jnp.asarray(perm)))


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_mla_decode_matches_jax(kv):
    """`_mla_decode` (the absorbed latent score) on each layout at ragged
    positions: the output and the cache after the in-place write."""
    cfg, jcfg = _cfgs()
    p, jp = _layer(jcfg)
    (dense, jdense), (paged, jpaged), (bt, jbt) = _latent_caches(cfg, jcfg)
    cache, jcache = (dense, jdense) if kv == "dense" else (paged, jpaged)
    tables = (bt, jbt) if kv == "paged" else (None, None)
    x, jx = _bf16_pair(np.random.default_rng(2), (3, 1, cfg.d_model))
    pos = np.array([2, 17, 30], np.int32)
    out, got = attn.attention_decode(x, p, cfg, cache, torch.from_numpy(pos),
                                     block_tables=tables[0])
    ref, want = jattn.attention_decode(jx, jp, jcfg, jcache, jnp.asarray(pos),
                                       block_tables=tables[1])
    np.testing.assert_allclose(_f(out), _f(ref), **TOL)
    assert got is cache and set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(_f(got[k]), _f(want[k]), **POOL_TOL)


def test_mla_paged_decode_bitwise_equals_dense():
    """The reference's invariant (tests/test_paged_kv.py): scattering the
    dense rings into permuted blocks, the paged decode reproduces the dense
    one bit for bit (the same plain attend on the same gathered view)."""
    cfg, jcfg = _cfgs()
    p, _ = _layer(jcfg)
    (dense, _), (paged, _), (bt, _) = _latent_caches(cfg, jcfg)
    x, _ = _bf16_pair(np.random.default_rng(2), (3, 1, cfg.d_model))
    pos = torch.tensor([2, 17, 30], dtype=torch.int32)
    out_d, _ = attn.attention_decode(x, p, cfg, dense, pos)
    out_p, _ = attn.attention_decode(x, p, cfg, paged, pos, block_tables=bt)
    assert torch.equal(out_d, out_p)


def test_mla_verify_matches_jax_and_its_decode_steps():
    """`_mla_verify` of 3 positions a row: output and pools against the
    reference, and each query bitwise the decode step at its position."""
    cfg, jcfg = _cfgs()
    p, jp = _layer(jcfg)
    _, (paged, jpaged), (bt, jbt) = _latent_caches(cfg, jcfg)
    snap = {k: v.clone() for k, v in paged.items()}
    x, jx = _bf16_pair(np.random.default_rng(4), (3, 3, cfg.d_model))
    pos = np.array([2, 17, 28], np.int32)
    out, got = attn.attention_verify(x, p, cfg, paged, torch.from_numpy(pos),
                                     block_tables=bt)
    ref, want = jattn.attention_verify(jx, jp, jcfg, jpaged, jnp.asarray(pos),
                                       block_tables=jbt)
    np.testing.assert_allclose(_f(out), _f(ref), **TOL)
    for k in got:
        np.testing.assert_allclose(_f(got[k]), _f(want[k]), **POOL_TOL)
    for s in range(3):
        step, _ = attn.attention_decode(x[:, s:s + 1], p, cfg, snap,
                                        torch.from_numpy(pos + s),
                                        block_tables=bt)
        assert torch.equal(step, out[:, s:s + 1]), s
    with pytest.raises(ValueError, match="paged"):
        attn.attention_verify(x, p, cfg, attn.init_kv_cache(cfg, 3, 32),
                              torch.from_numpy(pos), block_tables=bt)


# ---------------------------------------------------------------------------
# the model: prefill + decode, chained chunks, loss and gradients
# ---------------------------------------------------------------------------

PROMPTS = [(0, 23, 32), (1, 9, 16), (2, 60, 64)]    # (slot, length, bucket)
SLOTS, MAX_LEN, BS, STEPS = 3, 128, 16, 6


def _run(kv, jax_side):
    """Prefill each of ``PROMPTS`` into its slot of a ``kv`` state, then
    ``STEPS`` teacher-forced decode steps.  Returns (prefill logits, decode
    logits, final state)."""
    cfg, jcfg, params, jparams = _model()
    prompts = [_prompt(cfg.vocab_size, n, plen, seed=slot)
               for slot, n, plen in PROMPTS]
    forced = np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(STEPS, SLOTS)).astype(np.int32)
    mb = MAX_LEN // BS
    rows = [list(range(1 + s * mb, 1 + (s + 1) * mb))[::-1]
            for s in range(SLOTS)]
    pre, dec = [], []
    if jax_side:
        state = jax_state(jcfg, SLOTS, MAX_LEN, kv=kv, block_size=BS)
        prefill, decode = _jax_fn("prefill"), _jax_fn("decode")
        for (slot, _, plen), toks in zip(PROMPTS, prompts):
            logits, cache = prefill(jparams,
                                    {"tokens": jnp.asarray(toks[None])})
            pre.append(_f(logits[0, -1]))
            state = (jax_install_paged(state, cache, slot, plen, 0,
                                       rows[slot], 0, BS) if kv == "paged"
                     else jax_install(state, cache, slot, plen, 0))
        for t in range(STEPS):
            state = {**state, "token": jnp.asarray(forced[t][:, None])}
            logits, state = decode(jparams, state)
            dec.append(_f(logits[:, 0]))
        return np.stack(pre), np.stack(dec), state
    bundle = build_model(cfg)
    state = init_decode_state(cfg, SLOTS, MAX_LEN, kv=kv, block_size=BS,
                              device=CPU)
    for (slot, _, plen), toks in zip(PROMPTS, prompts):
        logits, cache = bundle.prefill(params,
                                       {"tokens": torch.from_numpy(toks[None])})
        pre.append(_f(logits[0, -1]))
        if kv == "paged":
            _install_slot_paged(state, cache, slot, plen, 0, rows[slot], 0,
                                BS)
        else:
            _install_slot(state, cache, slot, plen, 0)
    for t in range(STEPS):
        state["token"] = torch.from_numpy(forced[t][:, None].copy())
        logits, state = bundle.decode(params, state)
        dec.append(_f(logits[:, 0]))
    return np.stack(pre), np.stack(dec), state


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_prefill_and_decode_match_jax(kv):
    """``lm_prefill`` of three ragged, left-padded prompts (the flash path,
    its V padded) installed into a ``kv`` state, then teacher-forced
    ``lm_decode`` steps (the absorbed latent score): every logit, the
    positions and the latent caches."""
    pp, pd, pstate = _run(kv, jax_side=False)
    jp, jd, jstate = _run(kv, jax_side=True)
    np.testing.assert_allclose(pp, jp, **TOL)
    np.testing.assert_allclose(pd, jd, **TOL)
    np.testing.assert_array_equal(pstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    keys = {"paged": {"ckvp", "kropep"}, "dense": {"ckv", "krope"}}[kv]
    for mine, ref in zip(pstate["cache"], jstate["cache"]):
        assert set(mine) == set(ref) == keys
        for key, v in mine.items():
            got, want = _f(v), _f(ref[key])
            if kv == "paged":              # scratch block 0: free-slot writes
                got, want = got[:, 1:], want[:, 1:]
            np.testing.assert_allclose(got, want, **POOL_TOL)


def _chain(C, jax_side, n=100):
    """Chunks of ``C`` tokens of an ``n``-token prompt into row 1 of a
    2-slot paged state (block 16); each chunk's logits, the state, and the
    one-shot prefill's last logits."""
    cfg, jcfg, params, jparams = _model()
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=n).astype(np.int32)
    mb = MAX_LEN // BS
    row = np.arange(1 + mb, 1 + 2 * mb).astype(np.int32)
    out = []
    if jax_side:
        state = jax_state(jcfg, 2, MAX_LEN, kv="paged", block_size=BS)
        chunk = _jax_fn("prefill_chunk")
        for off in range(0, n, C):
            logits, state = chunk(jparams, state,
                                  jnp.asarray(prompt[None, off:off + C]),
                                  jnp.asarray(row), jnp.int32(1),
                                  jnp.int32(off))
            out.append(_f(logits))
        one, _ = _jax_fn("prefill")(jparams,
                                    {"tokens": jnp.asarray(prompt[None])})
        return np.concatenate(out), _f(one[:, -1]), state
    bundle = build_model(cfg)
    state = init_decode_state(cfg, 2, MAX_LEN, kv="paged", block_size=BS,
                              device=CPU)
    for off in range(0, n, C):
        logits, _ = bundle.prefill_chunk(
            params, state, torch.from_numpy(prompt[None, off:off + C]),
            torch.from_numpy(row), 1, off)
        out.append(_f(logits))
    one, _ = bundle.prefill(params, {"tokens": torch.from_numpy(prompt[None])})
    return np.concatenate(out), _f(one[:, -1]), state


@pytest.mark.parametrize("C", [16, 32])
def test_lm_prefill_chunk_chained_matches_jax(C):
    """`_mla_prefill_chunk` chained over a 100-token prompt at chunk/block
    ratios 1 and 2 (the last chunk ragged): each chunk's logits and the
    latent pools against the reference, and in each package the last
    chunk's logits against the one-shot prefill's (absorbed against
    expanded math)."""
    got, one, state = _chain(C, jax_side=False)
    want, jone, jstate = _chain(C, jax_side=True)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[-1:], one, **TOL)
    np.testing.assert_allclose(want[-1:], jone, **TOL)
    for leaf, jleaf in zip(state["cache"], jstate["cache"]):
        assert set(leaf) == set(jleaf) == {"ckvp", "kropep"}
        for k, v in leaf.items():
            np.testing.assert_allclose(_f(v), _f(jleaf[k]), **POOL_TOL)


def test_chunk_needs_the_paged_pools():
    cfg, _, params, _ = _model()
    state = init_decode_state(cfg, 2, MAX_LEN, kv="dense", device=CPU)
    with pytest.raises(ValueError, match="admits one-shot"):
        build_model(cfg).prefill_chunk(
            params, state, torch.zeros((1, 16), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32), 0, 0)


_BATCH_SEED = 1


def _batch(vocab):
    rng = np.random.default_rng(_BATCH_SEED)
    return {k: rng.integers(0, vocab, (2, 64)).astype(np.int32)
            for k in ("tokens", "targets")}


def test_lm_loss_matches_jax():
    """``ModelBundle.loss`` on the plain paths (training's), f32 master
    weights, bf16 compute."""
    cfg, jcfg = _cfgs(**PLAIN)
    nb = _batch(cfg.vocab_size)
    jloss, jm = jax.jit(jax_build(jcfg).loss)(_ref_tree(),
                                              jax.tree.map(jnp.asarray, nb))
    params = params_from_numpy(_ref_tree(), cfg, device=CPU,
                               matrix_dtype=torch.float32)
    with torch.no_grad():
        loss, m = build_model(cfg).loss(
            params, {k: torch.from_numpy(v) for k, v in nb.items()})
    assert abs(float(m["ce"]) - float(jm["ce"])) < LOSS_TOL
    assert abs(float(loss) - float(jloss)) < LOSS_TOL
    assert float(m["aux"]) == float(jm["aux"]) == 0.0


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_every_gradient_leaf_matches_jax_grad(compute):
    """Every leaf of the port's gradient (the latent norms and projections
    included) against ``jax.grad`` of the reference's loss, as ||g - g_ref||
    / ||g_ref||; none missing or zero where the reference's is not."""
    cfg, jcfg = _cfgs(**PLAIN)
    jdt, tdt = ((jnp.float32, torch.float32) if compute == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    nb = _batch(cfg.vocab_size)
    jb = jax_build(jcfg, compute=jdt)
    jnb = jax.tree.map(jnp.asarray, nb)
    grads = jax.jit(jax.grad(lambda p: jb.loss(p, jnb)[0]))(_ref_tree())
    params = params_from_numpy(_ref_tree(), cfg, device=CPU,
                               matrix_dtype=torch.float32).requires_grad_(True)
    loss, _ = build_model(cfg, compute=tdt).loss(
        params, {k: torch.from_numpy(v) for k, v in nb.items()})
    loss.backward()
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, grads))
    mine = tree.leaves(params.live())
    assert len(mine) == len(want)
    names = set()
    for (path, g), p in zip(want, mine):
        name = jax.tree_util.keystr(path)
        names.add(name.split("['")[-1])
        got = p.grad.numpy()
        assert got.shape == g.shape and np.isfinite(got).all(), name
        assert np.abs(g).max() > 0 and np.abs(got).max() > 0, name
        rel = float(np.linalg.norm(got - g) / np.linalg.norm(g))
        assert rel < GRAD_TOL[compute], (name, rel)
    assert {"q_norm']", "kv_norm']", "wkv_b']"} <= names


def test_train_payload_runs_the_plain_paths():
    """A few train steps of the smoke config through ``train_direct``:
    finite losses."""
    out = train_direct(get_smoke_config(ARCH), 3, 2, 32, device=CPU)
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 3


# ---------------------------------------------------------------------------
# the kernel flags on the MLA paths
# ---------------------------------------------------------------------------

def test_prefill_reaches_flash_at_qk_width_and_latent_norms_stay_plain(
        monkeypatch):
    """On the kernel flags a prefill layer attends through the flash
    wrapper once, at q/k/v width ``qk_head_dim`` (V zero-padded), and the
    RMSNorm wrapper runs for the mixer, FFN and final norms only:
    ``q_norm``/``kv_norm`` are the plain `rmsnorm`, as in the reference.
    Decode and chunks reach no attention kernel."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    cfg, _, params, _ = _model()
    calls = {"flash": [], "norm": 0}
    flash, norm = fa.flash_attention, rn.rmsnorm_fused

    def rec_flash(q, k, v, **kw):
        calls["flash"].append((tuple(q.shape), tuple(k.shape),
                               tuple(v.shape), bool(v[..., -8:].any())))
        return flash(q, k, v, **kw)

    def rec_norm(*a, **kw):
        calls["norm"] += 1
        return norm(*a, **kw)
    monkeypatch.setattr(fa, "flash_attention", rec_flash)
    monkeypatch.setattr(rn, "rmsnorm_fused", rec_norm)
    bundle = build_model(cfg)
    bundle.prefill(params, {"tokens": torch.ones((1, 16), dtype=torch.int32)})
    H, Dq = cfg.num_heads, cfg.mla.qk_head_dim
    assert calls["flash"] == [((1, 16, H, Dq),) * 3 + (False,)] \
        * cfg.num_layers
    assert calls["norm"] == 2 * cfg.num_layers + 1
    calls["flash"].clear()
    state = init_decode_state(cfg, 2, 64, device=CPU)
    bundle.decode(params, state)
    bundle.prefill_chunk(params, state, torch.ones((1, 16), dtype=torch.int32),
                         torch.zeros((4,), dtype=torch.int32), 0, 0)
    assert not calls["flash"]


# ---------------------------------------------------------------------------
# the reference's invariants inside the port (engine streams bitwise)
# ---------------------------------------------------------------------------

def test_prefill_matches_step_by_step_decode():
    """tests/test_arch_smoke.py's cache invariant: prefilling 8 tokens and
    decoding them one by one from an empty cache give the same last
    logits (the reference's rtol 0.1, atol 0.15)."""
    cfg = get_smoke_config(ARCH)
    bundle = build_model(cfg)
    params = bundle.init(0, device=CPU)
    toks = (torch.arange(8, dtype=torch.int32)[None] * 7 + 3) % cfg.vocab_size
    logits_p, _ = bundle.prefill(params, {"tokens": toks})
    state = init_decode_state(cfg, 1, 8, kv="dense", device=CPU)
    for i in range(8):
        state["token"] = toks[:, i:i + 1].clone()
        logits_d, state = bundle.decode(params, state)
    np.testing.assert_allclose(_f(logits_p), _f(logits_d), rtol=0.1,
                               atol=0.15)


def _reqs(vocab, lens, max_new=8):
    return [Request(rid=i, prompt=np.random.default_rng(100 + i).integers(
        0, vocab, size=n).astype(np.int32), max_new_tokens=max_new)
        for i, n in enumerate(lens)]


def _streams(cfg, params, lens, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 128)
    eng = ServeEngine(cfg, params, device=CPU, **kw)
    for r in _reqs(cfg.vocab_size, lens):
        eng.submit(r)
    stats = eng.run()
    assert stats["d2h_transfers"] == stats["decode_steps"] > 0
    assert eng.block_leaks() == 0
    return eng, {rid: r.tokens for rid, r in eng.done.items()}


LENS = [9, 40, 23, 70, 5]


def test_dense_streams_equal_paged_and_dense_admits_oneshot():
    """Paged and dense engines give the same streams; a dense MLA engine
    admits one-shot whatever ``prefill`` asks (the reference's gate) and
    falls back from speculation with the reason."""
    cfg, _, params, _ = _model()
    eng, paged = _streams(cfg, params, LENS)
    assert eng.kv == "paged" and eng.prefix is not None
    assert set(eng.state["cache"][0]) == {"ckvp", "kropep"}
    for kw in (dict(), dict(prefill="chunked", prefill_chunk=16),
               dict(spec="draft")):
        d, dense = _streams(cfg, params, LENS, kv="dense", **kw)
        assert d.prefill_mode == "oneshot" and d.spec == "off", kw
        assert dense == paged and len(paged) == len(LENS), kw
    assert "dense" in d.spec_fallback_reason


def test_chunked_admission_beside_a_decoding_slot_is_its_idle_run():
    """tests/test_paged_kv.py's MLA case: a request admitted chunk by chunk
    while another slot decodes gives its idle-engine stream bit for bit,
    and the mid-admission guard snapshots no latent pool."""
    cfg, _, params, _ = _model()
    kw = dict(slots=2, max_len=64, prefill="chunked", prefill_chunk=16)
    solo = ServeEngine(cfg, params, device=CPU, **kw)
    solo.submit(Request(1, np.random.default_rng(1).integers(
        0, cfg.vocab_size, 30).astype(np.int32), 3))
    solo.run()
    eng = ServeEngine(cfg, params, device=CPU, **kw)
    for i, (n, m) in enumerate([(20, 12), (30, 3), (7, 4)]):
        eng.submit(Request(i, np.random.default_rng(i).integers(
            0, cfg.vocab_size, n).astype(np.int32), m))
    guarded = []
    while eng.queue or eng._live or eng._jobs:
        if eng._jobs:
            guarded.append(eng._guard_rows())
        eng.step()
    assert guarded and all(g is None for g in guarded)
    assert eng.prefill_chunks >= 3
    assert [len(eng.done[i].tokens) for i in range(3)] == [13, 4, 5]
    assert eng.done[1].tokens == solo.done[1].tokens
    assert eng.block_leaks() == 0


@pytest.mark.parametrize("draft", ["self", "cold"])
def test_spec_tokens_bitwise_equal_off(draft):
    """tests/test_spec_decode.py's MLA case: a self draft (acceptance
    high) and a cold draft of other weights (acceptance near 0) both
    commit exactly the spec="off" greedy tokens."""
    cfg, _, params, _ = _model()
    _, base = _streams(cfg, params, LENS, slots=3)
    kw = {} if draft == "self" else dict(
        draft_cfg=cfg, draft_params=build_model(cfg).init(1, device=CPU))
    eng, got = _streams(cfg, params, LENS, slots=3, spec="draft", spec_k=4,
                        **kw)
    assert eng.spec == "draft", eng.spec_fallback_reason
    assert got == base
    stats = eng._stats(0, 1.0)
    if draft == "self":
        assert stats["acceptance_rate"] > 0.5
    else:
        assert stats["acceptance_rate"] < 0.5


def test_prefix_hit_gives_the_streams_of_a_miss():
    """A second request sharing a 48-token prefix maps the first's full
    latent blocks copy-free (the shared blocks are not written) and gives
    the stream of an engine without prefix sharing."""
    cfg, _, params, _ = _model()
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, 60).astype(np.int32)
    prompts = [shared, np.concatenate([shared[:48], rng.integers(
        0, cfg.vocab_size, 12).astype(np.int32)])]
    out = {}
    for sharing in (True, False):
        eng = ServeEngine(cfg, params, slots=1, max_len=96, device=CPU,
                          prefix_sharing=sharing)
        eng.submit(Request(0, prompts[0], 5))
        eng.run()
        eng.submit(Request(1, prompts[1], 5))
        eng.step()
        if sharing:
            assert eng.prefix.hits > 0
            ids = torch.tensor([b for b in eng._slot_blocks[0]
                                if eng.allocator.refcount(b) > 1])
            assert len(ids)
            before = [v[:, ids].clone() for v in eng.state["cache"][0]
                      .values()]
        eng.run()
        if sharing:
            assert all(torch.equal(a, v[:, ids]) for a, v in zip(
                before, eng.state["cache"][0].values()))
        assert eng.block_leaks() == 0
        out[sharing] = {rid: r.tokens for rid, r in eng.done.items()}
    assert out[True] == out[False]


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_serve_direct_and_the_serve_image():
    """The serve entry point answers a trace on the smoke config (paged,
    one-shot and chunked) with every request's full token count, and the
    arch's serve image pulls and builds an engine on the kernel flags."""
    cfg = get_smoke_config(ARCH)
    trace = make_trace(cfg.vocab_size, 4, max_len=128, prompt_len=(5, 100),
                       max_new_tokens=6)
    want = {e["rid"]: expected_tokens(e, 128) for e in trace}
    streams = []
    for kw in (dict(), dict(prefill="chunked", prefill_chunk=32)):
        stats = serve_direct(cfg, 4, 2, 128, prompt_len=(5, 100),
                             max_new_tokens=6, device=CPU, **kw)
        assert stats["tokens_per_request"] == want and stats["kv"] == "paged"
        streams.append(stats["streams"])
    assert streams[0] == streams[1]
    exe = ExecutableRegistry().pull(PayloadImage(ARCH, "smoke", "serve"), CPU)
    eng = exe.fn(exe.make_inputs(0), slots=2, max_len=64)
    assert eng.cfg.mla is not None and eng.kv == "paged"
    assert eng.cfg.attn_impl == "chunked"


@pytest.mark.parametrize("prefill", ["oneshot", "chunked"])
def test_warm_admission_and_install_leave_the_streams(prefill):
    """`warm_admission` (a prefill per bucket, a chunk per chunk shape
    into the scratch block) and `warm_install` (an admission, a step and
    an eviction per bucket) leave an MLA engine's streams those of an
    engine never warmed."""
    cfg, _, params, _ = _model()
    kw = dict(prefill=prefill, prefill_chunk=16)
    eng = ServeEngine(cfg, params, slots=2, max_len=128, device=CPU, **kw)
    eng.warm_admission()
    eng.warm_install()
    assert eng.steps == 0 and not eng.done and eng.block_leaks() == 0
    for r in _reqs(cfg.vocab_size, LENS):
        eng.submit(r)
    eng.run()
    _, want = _streams(cfg, params, LENS, **kw)
    assert {rid: r.tokens for rid, r in eng.done.items()} == want


def test_images_bind_through_a_pilot():
    """One pilot late-binds smollm-360m, then minicpm3-4b (prefetched):
    both serve payloads exit 0 with every request completed, the second
    bind a cache hit; minicpm3's train image runs its plain train step."""
    from repro_torch.launch.serve import serve_via_pilots
    out = serve_via_pilots(["smollm-360m", ARCH], n_requests=3, smoke=True,
                           device=CPU, slots=2, max_len=64)
    assert out["drained"]
    assert [p["exitcode"] for p in out["payloads"]] == [0, 0]
    assert [p["serve"]["completed"] for p in out["payloads"]] == [3, 3]
    assert out["payloads"][1]["bind_cached"] is True
    exe = ExecutableRegistry().pull(PayloadImage(ARCH, "smoke", "train"), CPU)
    state, data = exe.make_inputs(0)
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in data.batch_at(0).items()}
    _, metrics = exe.fn(state, batch)
    assert np.isfinite(float(metrics["loss"]))
