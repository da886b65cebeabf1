"""The port's model slice against the JAX package: parameter bridge,
one-shot prefill, and teacher-forced paged decode.

Both packages run ``smollm-360m``'s smoke config with the reference's own
parameters (``build_model(cfg).init(jax.random.key(0))``, bridged) and
``attn_impl="pallas"``, ``norm_impl="pallas"`` on both sides: the JAX
Pallas kernels in interpret mode, the port's kernel wrappers on their plain
versions (CPU tensors).

Tolerance for logits: atol=1e-2, rtol=1e-2.  The logits are bf16 products
(the reference's einsum rounds to bf16 before the f32 cast), so one bf16
ulp at |logit| in [0.25, 0.5) is 2e-3; through two layers of bf16
activations the two libraries round at the same points but sum in other
orders, which costs a few ulps (3e-3 measured at |logit| < 0.5).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke
from repro.models.api import build_model as jax_build
from repro.models.api import init_decode_state as jax_state
from repro.serving.engine import _install_slot_paged as jax_install
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import attention as attn
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.serving.engine import _install_slot_paged

LOGIT_TOL = dict(rtol=1e-2, atol=1e-2)
# K/V rows are bf16 values of magnitude up to ~4: one bf16 ulp is 1.6e-2
POOL_TOL = dict(rtol=2e-2, atol=2e-2)
ARCH = "smollm-360m"


def _cfgs(attn_impl="pallas", norm_impl="pallas"):
    kw = dict(attn_impl=attn_impl, norm_impl=norm_impl)
    return (dataclasses.replace(get_smoke_config(ARCH), **kw),
            dataclasses.replace(jax_smoke(ARCH), **kw))


@pytest.fixture(scope="module")
def ref_tree():
    _, jcfg = _cfgs()
    return jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(0)))


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# parameter bridge
# ---------------------------------------------------------------------------

def test_bridge_round_trip(ref_tree):
    """Norm scales (and every other leaf the bridge keeps f32: routers,
    the SSM mixer's A_log, dt_bias, D_skip, norm_scale) come back exactly;
    matrices come back as their bf16 rounding (what the reference's
    ``.astype(bf16)`` gives at use), and a bf16 tree round-trips bit for
    bit."""
    cfg, _ = _cfgs()
    params = params_from_numpy(ref_tree, cfg, device="cpu")
    assert params.layers[0]["mixer"]["wq"].dtype == torch.bfloat16
    assert params.layers[0]["mixer_norm"]["scale"].dtype == torch.float32
    back = params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(ref_tree)

    def bf16_round(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    for (path, got), want in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree.leaves(ref_tree)):
        exact = any(name in jax.tree_util.keystr(path)
                    for name in ("scale", "router", "A_log", "dt_bias",
                                 "D_skip"))
        np.testing.assert_array_equal(got, want if exact else bf16_round(want))
    bf16_tree = jax.tree.map(
        lambda a: a if a.ndim == 1 else np.asarray(jnp.asarray(a, jnp.bfloat16)),
        ref_tree)
    again = params_to_numpy(params_from_numpy(bf16_tree, cfg, device="cpu"))
    for got, want in zip(jax.tree.leaves(again), jax.tree.leaves(bf16_tree)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# the slice: prefill + teacher-forced paged decode
# ---------------------------------------------------------------------------

SLOTS, MAX_LEN, BS = 2, 64, 16
PROMPTS = [(0, 23), (1, 9)]                 # (slot, prompt length)
ROWS = [[3, 7, 1, 5], [6, 2, 8, 4]]         # permuted physical blocks


def _run_port(cfg, tree, steps, forced):
    bundle = build_model(cfg)
    params = params_from_numpy(tree, cfg, device="cpu")
    state = init_decode_state(cfg, SLOTS, MAX_LEN, block_size=BS, device="cpu")
    prefill_logits = []
    for (slot, plen), toks in zip(PROMPTS, forced["prompts"]):
        logits, cache = bundle.prefill(params,
                                       {"tokens": torch.from_numpy(toks[None])})
        prefill_logits.append(_f(logits[0, -1]))
        _install_slot_paged(state, cache, slot, plen, 0, ROWS[slot], 0, BS)
    out = []
    for t in range(steps):
        state["token"] = torch.from_numpy(forced["decode"][t][:, None].copy())
        logits, state = bundle.decode(params, state)
        out.append(_f(logits[:, 0]))
    return np.stack(prefill_logits), np.stack(out), state


def _run_jax(jcfg, tree, steps, forced):
    bundle = jax_build(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    state = jax_state(jcfg, SLOTS, MAX_LEN, kv="paged", block_size=BS)
    prefill = jax.jit(bundle.prefill)
    prefill_logits = []
    for (slot, plen), toks in zip(PROMPTS, forced["prompts"]):
        logits, cache = prefill(params, {"tokens": jnp.asarray(toks[None])})
        prefill_logits.append(_f(logits[0, -1]))
        state = jax_install(state, cache, slot, plen, 0, ROWS[slot], 0, BS)
    decode = jax.jit(bundle.decode)
    out = []
    for t in range(steps):
        state = {**state, "token": jnp.asarray(forced["decode"][t][:, None])}
        logits, state = decode(params, state)
        out.append(_f(logits[:, 0]))
    return np.stack(prefill_logits), np.stack(out), state


def _forced(vocab, steps, seed=0):
    rng = np.random.default_rng(seed)
    prompts = []
    for _slot, n in PROMPTS:
        plen = 16 if n <= 16 else 32                 # admit_length buckets
        toks = np.zeros((plen,), np.int32)
        toks[-n:] = rng.integers(0, vocab, size=n)   # left-padded
        prompts.append(toks)
    return {"prompts": prompts,
            "decode": rng.integers(0, vocab, size=(steps, SLOTS)).astype(np.int32)}


def test_slice_logits_match_jax(ref_tree):
    """Prefill plus 8 teacher-forced paged decode steps of two ragged rows:
    the port's logits match the reference's, with the hand-kernel path
    selected on both sides."""
    cfg, jcfg = _cfgs()
    forced = _forced(cfg.vocab_size, 8)
    pp, pd, pstate = _run_port(cfg, ref_tree, 8, forced)
    jp, jd, jstate = _run_jax(jcfg, ref_tree, 8, forced)
    np.testing.assert_allclose(pp, jp, **LOGIT_TOL)
    np.testing.assert_allclose(pd, jd, **LOGIT_TOL)
    np.testing.assert_array_equal(pstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    # the pools agree outside the scratch block 0 (free-slot duplicate
    # writes may land there in any order)
    for mine, ref in zip(pstate["cache"], jstate["cache"]):
        for key in ("kp", "vp"):
            np.testing.assert_allclose(_f(mine[key][:, 1:]),
                                       _f(ref[key][:, 1:]), **POOL_TOL)


def test_kernel_path_matches_plain_path(ref_tree):
    """Inside the port: the hand-kernel path (attn/norm "pallas") against
    the plain path that mirrors the reference's pure-JAX code (chunked
    prefill attention, decode_attend over the gathered pool, jnp RMSNorm).
    Both compute the same function with other rounding orders."""
    cfg_k, _ = _cfgs()
    cfg_p, _ = _cfgs("chunked", "jnp")
    forced = _forced(cfg_k.vocab_size, 4, seed=1)
    kp, kd, _ = _run_port(cfg_k, ref_tree, 4, forced)
    pp, pd, _ = _run_port(cfg_p, ref_tree, 4, forced)
    np.testing.assert_allclose(kp, pp, **LOGIT_TOL)
    np.testing.assert_allclose(kd, pd, **LOGIT_TOL)


@pytest.mark.parametrize("attn_impl", ["pallas", "chunked"])
def test_paged_decode_independent_of_block_placement(attn_impl):
    """The same logical KV under two physical block layouts gives bitwise
    the same decode output and writes (the paged counterpart of the
    reference's paged == dense test)."""
    cfg, _ = _cfgs(attn_impl, "jnp")
    gen = torch.Generator().manual_seed(1)
    p = attn.init_attention(gen, cfg)
    B, mb, bs = 3, 2, 16
    nb = B * mb + 1
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    rows = torch.randn((B * mb, bs, K, Dh), generator=gen).to(torch.bfloat16)
    x = torch.randn((B, 1, cfg.d_model), generator=gen).to(torch.bfloat16)
    pos = torch.tensor([2, 17, 30], dtype=torch.int32)
    outs = []
    for ids in (np.arange(1, nb), np.random.default_rng(0).permutation(
            np.arange(1, nb))):
        tables = torch.from_numpy(ids.reshape(B, mb).astype(np.int32))
        pool = {k: torch.zeros((nb, bs, K, Dh), dtype=torch.bfloat16)
                for k in ("kp", "vp")}
        for key in pool:
            pool[key][torch.from_numpy(ids).long()] = rows
        out, new = attn.attention_decode(x, p, cfg, pool, pos,
                                         block_tables=tables)
        outs.append((out, {k: v[torch.from_numpy(ids).long()]
                           for k, v in new.items()}))
    assert torch.equal(outs[0][0], outs[1][0])
    for key in ("kp", "vp"):
        assert torch.equal(outs[0][1][key], outs[1][1][key])
