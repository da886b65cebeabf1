"""The port's gemma-2b, starcoder2-3b and mixtral-8x7b against the JAX
package: configs, LayerNorm, the sliding-window (SWA) rings, and each
arch's prefill, decode, chained prefill chunks and loss.

Inputs are made with numpy from a seed and handed to both packages; model
and layer parameters are the reference's own (``jax.random`` keys),
bridged.  Both sides run the serve entry's kernel flags
(``attn_impl="pallas"``, ``norm_impl="pallas"``, ``moe_impl="gmm"``): the
JAX Pallas kernels in interpret mode, the port's wrappers on their plain
versions (CPU tensors).  The loss runs the plain paths, as training does.

mixtral-8x7b's smoke config has a window of 64, so its prompts of 100 and
more tokens roll the prefill write, decodes from position 64 on overwrite
the ring, and chunks of 32, 64 and 96 tokens run at chunk/window ratios
0.5, 1 and 1.5.

Tolerances, and why:

* Ring writes (`_ring_write_full`, the decode write at ``pos mod T``):
  bitwise, they move values.
* Norms: f32 rtol = atol = 1e-5 (the same f32 ops in another library);
  bf16 2e-2 (one or two bf16 ulps), as tests/test_torch_layers.py.
* Layer outputs and logits: rtol = atol = 1e-2, tests/test_torch_model.py's
  (bf16 activations rounded at the same points, summed in other orders);
  K/V rings and pools 2e-2 (one bf16 ulp at |x| ~ 4).
* Chained chunks against the one-shot prefill, inside one package: the
  same 1e-2 (the chunk attends in another order than the flash path).
* The loss: 2e-3, the MoE aux loss 1e-2 relative, tests/test_torch_train.py's.
* Inside the port: streams bitwise.
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
from repro.configs.base import list_archs as jax_archs
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models.api import build_model as jax_build
from repro.models.api import init_decode_state as jax_state
from repro.serving.engine import _install_slot as jax_install
from repro.serving.engine import _install_slot_paged as jax_install_paged
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import base as tbase
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.images import ExecutableRegistry, PayloadImage
from repro_torch.launch.serve import (
    expected_tokens, make_trace, serve_direct, serve_via_pilots)
from repro_torch.models import attention as attn
from repro_torch.models import layers as tl
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.serving.engine import (
    Request, ServeEngine, _install_slot, _install_slot_paged)

GEMMA, STARCODER, MIXTRAL = "gemma-2b", "starcoder2-3b", "mixtral-8x7b"
ARCHS = (GEMMA, STARCODER, MIXTRAL)
KERNELS = dict(attn_impl="pallas", norm_impl="pallas", moe_impl="gmm")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
TOL = dict(rtol=1e-2, atol=1e-2)
POOL_TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_TOL = 2e-3
AUX_TOL = 1e-2
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


def _cfgs(arch, **kw):
    kw = {**KERNELS, **kw}
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


_TREES: dict = {}


def _ref_tree(arch):
    """The reference's f32 parameters of ``arch``'s smoke config (numpy),
    from key 0."""
    if arch not in _TREES:
        _, jcfg = _cfgs(arch)
        _TREES[arch] = jax.tree.map(
            np.asarray, jax_build(jcfg).init(jax.random.key(0)))
    return _TREES[arch]


def _model(arch, **kw):
    """(cfg, jcfg, port params (bf16 serve layout), jax params)."""
    cfg, jcfg = _cfgs(arch, **kw)
    tree = _ref_tree(arch)
    return (cfg, jcfg, params_from_numpy(tree, cfg, device=CPU),
            jax.tree.map(jnp.asarray, tree))


def _prompt(vocab, n, plen, seed):
    """A left-padded prompt of ``n`` tokens in a bucket of ``plen``."""
    toks = np.zeros((plen,), np.int32)
    toks[-n:] = np.random.default_rng(seed).integers(0, vocab, size=n)
    return toks


# ---------------------------------------------------------------------------
# configs, and the archs the port still refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_the_reference(arch, smoke):
    mine = (get_smoke_config if smoke else get_config)(arch)
    ref = (jax_smoke if smoke else jax_config)(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()


def test_full_configs_as_the_reference_states_them():
    """gemma: MQA at head width 256, GeGLU, tied; starcoder2: LayerNorm,
    plain-gelu MLP, no window; mixtral: a window of 4096, 8 experts top 2."""
    g, s, m = (get_config(a) for a in ARCHS)
    assert (g.num_kv_heads, g.head_dim, g.activation, g.tie_embeddings,
            g.norm) == (1, 256, "gelu", True, "rmsnorm")
    assert (s.norm, s.mlp_gated, s.sliding_window, s.num_heads,
            s.num_kv_heads, s.head_dim) == ("layernorm", False, None, 24, 2,
                                            128)
    assert (m.sliding_window, m.moe.num_experts, m.moe.top_k,
            m.num_kv_heads, m.head_dim) == (4096, 8, 2, 8, 128)


def _port_cfg(jcfg):
    """The port's ArchConfig with a reference config's fields."""
    specs = {"moe": tbase.MoESpec, "mla": tbase.MLASpec, "ssm": tbase.SSMSpec}
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if f.name in specs and v is not None:
            v = specs[f.name](**dataclasses.asdict(v))
        kw[f.name] = v
    return tbase.ArchConfig(**kw)


@pytest.mark.parametrize("arch,item", [
    ("jamba-v0.1-52b", "Hybrid"),
    ("whisper-small", "Encoder-decoder"),
    ("llava-next-mistral-7b", "VLM frontend")])
def test_later_families_still_raise_naming_their_item(arch, item):
    assert arch in jax_archs()
    cfg = _port_cfg(jax_smoke(arch))
    with pytest.raises(NotImplementedError,
                       match=f"Queue 1 item 6, {item}"):
        build_model(cfg)


# ---------------------------------------------------------------------------
# LayerNorm and its f32 bias
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32) * 3 + 1
    scale = (1 + rng.normal(size=(64,)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    if dtype == "bf16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj, tol = jnp.asarray(xt.float().numpy(), jnp.bfloat16), BF16_TOL
    else:
        xt, xj, tol = torch.from_numpy(x), jnp.asarray(x), F32_TOL
    out = tl.layernorm(xt, torch.from_numpy(scale), torch.from_numpy(bias))
    ref = jl.layernorm(xj, jnp.asarray(scale), jnp.asarray(bias))
    assert out.dtype == xt.dtype
    np.testing.assert_allclose(_f(out), _f(ref), **tol)


def test_layernorm_init_and_the_kernel_flag():
    """``scale`` ones and ``bias`` zeros in f32 (not ``1 + scale``), and
    the LayerNorm branch is taken before ``norm_impl``: starcoder2 on the
    kernel flags launches no RMSNorm kernel."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
    cfg = dataclasses.replace(get_smoke_config(STARCODER), norm_impl="pallas")
    p = tl.init_norm(cfg)
    assert set(p) == {"scale", "bias"}
    assert p["scale"].dtype == p["bias"].dtype == torch.float32
    assert bool((p["scale"] == 1).all()) and not p["bias"].any()
    jp = jl.init_norm(None, jax_smoke(STARCODER))
    for k in p:
        np.testing.assert_array_equal(_f(p[k]), _f(jp[k]))
    before = rmsnorm_fused.launches
    x = torch.randn((2, 3, cfg.d_model)).to(torch.bfloat16)
    out = tl.apply_norm(x, p, cfg)
    assert rmsnorm_fused.launches == before
    assert torch.equal(out, tl.layernorm(x, p["scale"], p["bias"]))


def test_bias_is_bridged_in_f32():
    """starcoder2's LayerNorm biases (the only leaves named ``bias`` in
    the three trees) cross the bridge in f32, exactly, both ways."""
    cfg, _ = _cfgs(STARCODER)
    tree = jax.tree.map(lambda a: a + np.float32(1e-3), _ref_tree(STARCODER))
    params = params_from_numpy(tree, cfg, device=CPU)
    for norm in ("mixer_norm", "ffn_norm"):
        assert params.layers[0][norm]["bias"].dtype == torch.float32
    assert params.final_norm["bias"].dtype == torch.float32
    back = params_to_numpy(params)
    for a, b in ((back["final_norm"]["bias"], tree["final_norm"]["bias"]),
                 (back["layers"][0]["ffn_norm"]["bias"],
                  tree["layers"][0]["ffn_norm"]["bias"])):
        np.testing.assert_array_equal(a, b)
    for arch in ARCHS:
        names = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_leaves_with_path(_ref_tree(arch))]
        biases = [n for n in names if n.endswith("['bias']")]
        assert all("norm" in n for n in biases), biases
        assert bool(biases) == (arch == STARCODER)


# ---------------------------------------------------------------------------
# the SWA ring helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,T", [(40, 64), (64, 64), (100, 64), (200, 64)])
def test_ring_write_full_matches_jax(S, T):
    """Padded below the ring's length, each slot's latest occupant above
    it (``pos = S-1 - ((S-1-slot) mod T)``), bitwise."""
    rng = np.random.default_rng(S)
    k, jk = _bf16_pair(rng, (2, S, 2, 8))
    v, jv = _bf16_pair(rng, (2, S, 2, 8))
    cache = {n: torch.zeros((2, T, 2, 8), dtype=torch.bfloat16)
             for n in ("k", "v")}
    jcache = {n: jnp.zeros((2, T, 2, 8), jnp.bfloat16) for n in ("k", "v")}
    got = attn._ring_write_full(k, v, cache)
    want = jattn._ring_write_full(jk, jv, jcache, 64)
    for n in ("k", "v"):
        np.testing.assert_array_equal(_f(got[n]), _f(want[n]))
    if S > T:                              # slot r holds a position = r mod T
        pos = [int(p) for p in range(S - T, S)]
        assert torch.equal(got["k"][:, [p % T for p in pos]], k[:, pos])


def test_swa_caches_are_window_rings():
    """``init_kv_cache`` keeps min(max_len, window) positions; the paged
    cache of an SWA layer is that ring (no pool), as the reference's."""
    cfg, jcfg = _cfgs(MIXTRAL)
    for max_len in (32, 64, 256):
        got = attn.init_kv_cache(cfg, 3, max_len)
        want = jattn.init_kv_cache(jcfg, 3, max_len)
        paged = attn.init_kv_cache_paged(cfg, 3, max_len, 17, 16)
        jpaged = jattn.init_kv_cache_paged(jcfg, 3, max_len, 17, 16)
        for mine, ref in ((got, want), (paged, jpaged)):
            assert {k: tuple(v.shape) for k, v in mine.items()} == \
                {k: tuple(v.shape) for k, v in ref.items()}
        assert got["k"].shape[1] == min(max_len, 64)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_attention_decode_on_a_rolling_ring_matches_jax(kv):
    """One decode layer over a 64-slot ring at positions before, at and
    past the window (max_len 256): the write lands at ``pos mod 64`` as the
    reference's, bitwise, every other slot untouched, and the output
    matches.  With a paged state an SWA layer's cache is still its ring."""
    cfg, jcfg = _cfgs(MIXTRAL)
    jp = jattn.init_attention(jax.random.key(1), jcfg)
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16)
         for k, v in jax.tree.map(np.asarray, jp).items()}
    rng = np.random.default_rng(4)
    B, T, K, Dh = 4, 64, cfg.num_kv_heads, cfg.head_dim
    k, jk = _bf16_pair(rng, (B, T, K, Dh))
    v, jv = _bf16_pair(rng, (B, T, K, Dh))
    x, jx = _bf16_pair(rng, (B, 1, cfg.d_model))
    pos = np.array([5, 63, 64, 130], np.int32)
    cache = {"k": k.clone(), "v": v.clone()}
    tables = (torch.zeros((B, 16), dtype=torch.int32) if kv == "paged"
              else None)
    out, _ = attn.attention_decode(x, p, cfg, cache, torch.from_numpy(pos),
                                   window=64, block_tables=tables)
    jout, jcache = jattn.attention_decode(jx, jp, jcfg, {"k": jk, "v": jv},
                                          jnp.asarray(pos), window=64)
    np.testing.assert_allclose(_f(out), _f(jout), **TOL)
    for n, old in (("k", k), ("v", v)):
        np.testing.assert_allclose(_f(cache[n]), _f(jcache[n]), **POOL_TOL)
        for b in range(B):
            slot = int(pos[b]) % T
            keep = [t for t in range(T) if t != slot]
            assert torch.equal(cache[n][b, keep], old[b, keep])
            np.testing.assert_array_equal(          # the slot of the ring
                np.flatnonzero((_f(cache[n][b]) != _f(old[b])).any((1, 2))),
                np.flatnonzero((_f(jcache[n][b]) != _f(old[b])).any((1, 2))))


# ---------------------------------------------------------------------------
# the model: prefill, teacher-forced decode, chained chunks, loss
# ---------------------------------------------------------------------------

# (slot, prompt length, bucket): mixtral's buckets 32 (a ring not yet
# full), 64 (decode crosses the window at once) and 128 (a rolling
# prefill); the others' 32, 16, 64
PROMPTS = {GEMMA: [(0, 23, 32), (1, 9, 16), (2, 60, 64)],
           STARCODER: [(0, 23, 32), (1, 9, 16), (2, 60, 64)],
           MIXTRAL: [(0, 23, 32), (1, 60, 64), (2, 100, 128)]}
SLOTS, MAX_LEN, BS, STEPS = 3, 256, 16, 8


def _run(arch, kv, jax_side):
    """Prefill each of ``PROMPTS[arch]`` into its slot of a ``kv`` state,
    then ``STEPS`` teacher-forced decode steps; with ``jax_side`` the
    reference does the same.  Returns (prefill logits, decode logits,
    final state)."""
    cfg, jcfg, params, jparams = _model(arch)
    rng = np.random.default_rng(11)
    prompts = [_prompt(cfg.vocab_size, n, plen, seed=slot)
               for slot, n, plen in PROMPTS[arch]]
    forced = rng.integers(0, cfg.vocab_size,
                          size=(STEPS, SLOTS)).astype(np.int32)
    mb = MAX_LEN // BS
    rows = [list(range(1 + s * mb, 1 + (s + 1) * mb))[::-1]
            for s in range(SLOTS)]
    pre, dec = [], []
    if jax_side:
        bundle = jax_build(jcfg)
        state = jax_state(jcfg, SLOTS, MAX_LEN, kv=kv, block_size=BS)
        prefill, decode = jax.jit(bundle.prefill), jax.jit(bundle.decode)
        for (slot, _, plen), toks in zip(PROMPTS[arch], prompts):
            logits, cache = prefill(jparams, {"tokens": jnp.asarray(toks[None])})
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
    for (slot, _, plen), toks in zip(PROMPTS[arch], prompts):
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


@pytest.mark.parametrize("arch,kv", [(GEMMA, "paged"), (STARCODER, "paged"),
                                     (MIXTRAL, "dense"), (MIXTRAL, "paged")])
def test_prefill_and_decode_match_jax(arch, kv):
    """``lm_prefill`` of three ragged, left-padded prompts and 8
    teacher-forced ``lm_decode`` steps: every logit, the positions, and
    the caches (mixtral's rings, rolled by the 128-token prefill and by
    the decodes past position 64; with a paged state too, where an SWA
    layer keeps its ring)."""
    pp, pd, pstate = _run(arch, kv, jax_side=False)
    jp, jd, jstate = _run(arch, kv, jax_side=True)
    np.testing.assert_allclose(pp, jp, **TOL)
    np.testing.assert_allclose(pd, jd, **TOL)
    np.testing.assert_array_equal(pstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    for mine, ref in zip(pstate["cache"], jstate["cache"]):
        assert set(mine) == set(ref)
        for key, v in mine.items():
            got, want = _f(v), _f(ref[key])
            if key in ("kp", "vp"):        # scratch block 0: free-slot writes
                got, want = got[:, 1:], want[:, 1:]
            np.testing.assert_allclose(got, want, **POOL_TOL)
    if arch == MIXTRAL:
        assert pstate["cache"][0]["k"].shape[2] == 64


def test_kernel_path_matches_plain_path_on_a_rolling_ring():
    """Inside the port, mixtral with the kernel flags against the plain
    path (chunked attention, jnp RMSNorm, einsum experts) through the same
    rolling prefill and window-crossing decodes."""
    cfg, _, params, _ = _model(MIXTRAL)
    plain = dataclasses.replace(cfg, attn_impl="chunked", norm_impl="jnp",
                                moe_impl="einsum")
    outs = []
    for c in (cfg, plain):
        bundle = build_model(c)
        state = init_decode_state(c, 2, MAX_LEN, kv="dense", device=CPU)
        logits = []
        for slot, (n, plen) in enumerate(((60, 64), (100, 128))):
            toks = _prompt(c.vocab_size, n, plen, seed=slot)
            lg, cache = bundle.prefill(
                params, {"tokens": torch.from_numpy(toks[None])})
            logits.append(lg[:, -1])
            _install_slot(state, cache, slot, plen, 0)
        for t in range(4):
            state["token"] = torch.full((2, 1), 7 + t, dtype=torch.int32)
            lg, state = bundle.decode(params, state)
            logits.append(lg[:, 0])
        outs.append(_f(torch.cat(logits)))
    np.testing.assert_allclose(outs[0], outs[1], **TOL)


def _no_drops(cfg):
    """``cfg`` with an MoE capacity of every token (capacity factor E/k):
    the one-shot prefill's capacity dispatch then drops no assignment, as
    the chunk path's dense-gated MoE never does (the reference's two
    paths; with drops they are different functions)."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def _chain(arch, C, jax_side, kv="dense", n=192):
    """Chunks of ``C`` tokens (chunk boundaries at multiples of C) of an
    ``n``-token prompt into slot 1 of a 2-slot state (max_len 256), then
    each chunk's logits and the state; and the last logits of the same
    prompt's one-shot prefill, with no MoE assignment dropped."""
    cfg, jcfg, params, jparams = _model(arch)
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=n).astype(np.int32)
    slots, slot = 2, 1
    mb = MAX_LEN // BS
    row = np.zeros((mb,), np.int32)
    if kv == "paged":
        row[:] = np.arange(1 + mb, 1 + 2 * mb)
    kw = dict(block_size=BS) if kv == "paged" else {}
    out = []
    if jax_side:
        bundle = jax_build(jcfg)
        state = jax_state(jcfg, slots, MAX_LEN, kv=kv, **kw)
        chunk = jax.jit(bundle.prefill_chunk)
        for off in range(0, n, C):
            toks = prompt[None, off:off + C]
            logits, state = chunk(jparams, state, jnp.asarray(toks),
                                  jnp.asarray(row), jnp.int32(slot),
                                  jnp.int32(off))
            out.append(_f(logits))
        one, _ = jax.jit(jax_build(_no_drops(jcfg)).prefill)(
            jparams, {"tokens": jnp.asarray(prompt[None])})
        return np.concatenate(out), _f(one[:, -1]), state
    bundle = build_model(cfg)
    state = init_decode_state(cfg, slots, MAX_LEN, kv=kv, device=CPU, **kw)
    for off in range(0, n, C):
        toks = torch.from_numpy(prompt[None, off:off + C])
        logits, _ = bundle.prefill_chunk(params, state, toks,
                                         torch.from_numpy(row), slot, off)
        out.append(_f(logits))
    one, _ = build_model(_no_drops(cfg)).prefill(
        params, {"tokens": torch.from_numpy(prompt[None])})
    return np.concatenate(out), _f(one[:, -1]), state


@pytest.mark.parametrize("arch,C,kv", [
    (MIXTRAL, 32, "dense"), (MIXTRAL, 64, "dense"), (MIXTRAL, 96, "dense"),
    (GEMMA, 48, "paged"), (STARCODER, 48, "paged")])
def test_lm_prefill_chunk_chained_matches_jax(arch, C, kv):
    """A 192-token prompt in chunks of C into row 1: every chunk's
    last-position logits and, after the last, every cache leaf against
    the reference; and, in each package, the last chunk's logits against
    the one-shot prefill's (at an MoE capacity that drops nothing).  For
    mixtral (window 64) C/W is 0.5, 1 and
    1.5: the chunk reads the ring's last 64 positions as they were before
    it and rolls it."""
    got, one, state = _chain(arch, C, jax_side=False, kv=kv)
    want, jone, jstate = _chain(arch, C, jax_side=True, kv=kv)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[-1:], one, **TOL)
    np.testing.assert_allclose(want[-1:], jone, **TOL)
    for leaf, jleaf in zip(state["cache"], jstate["cache"]):
        assert set(leaf) == set(jleaf)
        for k, v in leaf.items():
            np.testing.assert_allclose(_f(v), _f(jleaf[k]), **POOL_TOL)
    if kv == "dense":
        assert not state["cache"][0]["k"][:, 0].any()   # row 0 untouched


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch):
    """``ModelBundle.loss`` on the plain paths (training's), f32 master
    weights, 128-token sequences (twice mixtral-smoke's window)."""
    cfg, jcfg = (dataclasses.replace(c, attn_impl="chunked", norm_impl="jnp",
                                     moe_impl="einsum")
                 for c in _cfgs(arch))
    rng = np.random.default_rng(0)
    nb = {k: rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
          for k in ("tokens", "targets")}
    jl_, jm = jax.jit(jax_build(jcfg).loss)(_ref_tree(arch),
                                            jax.tree.map(jnp.asarray, nb))
    params = params_from_numpy(_ref_tree(arch), cfg, device=CPU,
                               matrix_dtype=torch.float32)
    with torch.no_grad():
        loss, m = build_model(cfg).loss(
            params, {k: torch.from_numpy(v) for k, v in nb.items()})
    assert abs(float(m["ce"]) - float(jm["ce"])) < LOSS_TOL
    assert abs(float(loss) - float(jl_)) < LOSS_TOL
    if cfg.moe is None:
        assert float(m["aux"]) == float(jm["aux"]) == 0.0
    else:
        assert abs(float(m["aux"]) - float(jm["aux"])) < \
            AUX_TOL * float(jm["aux"])


# ---------------------------------------------------------------------------
# the engine and the entry points (inside the port, bitwise)
# ---------------------------------------------------------------------------

def _reqs(vocab, lens, max_new=10):
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


@pytest.mark.parametrize("arch", [GEMMA, STARCODER])
def test_dense_streams_equal_paged(arch):
    cfg, _, params, _ = _model(arch)
    lens = [9, 40, 23, 70, 5]
    eng, paged = _streams(cfg, params, lens)
    assert eng.kv == "paged" and eng.prefix is not None
    _, dense = _streams(cfg, params, lens, kv="dense")
    assert paged == dense and len(paged) == len(lens)


def test_swa_engine_is_dense_without_prefix_cache_or_speculation():
    """mixtral serves on its dense rings whatever ``kv`` asks, keeps no
    prefix cache, and falls back from speculation with the reason; its
    streams are those of the plain dense engine."""
    cfg, _, params, _ = _model(MIXTRAL)
    lens = [100, 9, 60, 23]
    base, want = _streams(cfg, params, lens)
    assert base.kv == "dense" and base.prefix is None
    assert base.state["cache"][0]["k"].shape[2] == 64
    for kw in (dict(kv="paged"), dict(spec="draft"),
               dict(kv="paged", prefix_sharing=True)):
        eng, got = _streams(cfg, params, lens, **kw)
        assert eng.kv == "dense" and eng.prefix is None and eng.spec == "off"
        assert got == want, kw
    eng, _ = _streams(cfg, params, [9], spec="draft")
    assert "SWA rolling rings" in eng.spec_fallback_reason


def test_swa_slot_isolation_across_a_rolling_admission():
    """A request's stream on mixtral's rings is bitwise its idle-engine
    run while another is admitted beside it mid-decode, with a rolling
    prefill (100 tokens, bucket 128) and decodes past the window."""
    cfg, _, params, _ = _model(MIXTRAL)
    alone = ServeEngine(cfg, params, slots=2, max_len=256, device=CPU)
    a, b = _reqs(cfg.vocab_size, [60, 100], max_new=20)
    alone.submit(dataclasses.replace(a, tokens=[]))
    alone.run()
    eng = ServeEngine(cfg, params, slots=2, max_len=256, device=CPU)
    eng.submit(a)
    for _ in range(5):
        eng.step()
    eng.submit(b)
    eng.run()
    assert eng.done[0].tokens == alone.done[0].tokens
    assert len(eng.done[1].tokens) == 21


@pytest.mark.parametrize("arch", ARCHS)
def test_warm_admission_and_install_leave_the_streams(arch):
    """`warm_admission` (a prefill per bucket, a chunk per chunk shape)
    and `warm_install` (a real admission, step and eviction per bucket)
    run on each arch's engine, one-shot and chunked, and leave its
    streams those of an engine never warmed."""
    cfg, _, params, _ = _model(arch)
    lens = [100, 9, 60]
    for kw in (dict(), dict(prefill="chunked", prefill_chunk=32)):
        eng = ServeEngine(cfg, params, slots=2, max_len=128, device=CPU,
                          **kw)
        eng.warm_admission()
        eng.warm_install()
        assert eng.steps == 0 and not eng.done
        for r in _reqs(cfg.vocab_size, lens):
            eng.submit(r)
        eng.run()
        _, want = _streams(cfg, params, lens, **kw)
        assert {rid: r.tokens for rid, r in eng.done.items()} == want, kw


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_direct_and_the_serve_image(arch):
    """The serve entry point answers a trace on each arch's smoke config
    with every request's full token count, and the arch's serve image
    pulls and builds an engine on the kernel flags."""
    cfg = get_smoke_config(arch)
    kw = dict(prompt_len=(5, 100), max_new_tokens=6, device=CPU)
    stats = serve_direct(cfg, 4, 2, 128, **kw)
    trace = make_trace(cfg.vocab_size, 4, max_len=128, prompt_len=(5, 100),
                       max_new_tokens=6)
    assert stats["tokens_per_request"] == {
        e["rid"]: expected_tokens(e, 128) for e in trace}
    assert stats["kv"] == ("dense" if arch == MIXTRAL else "paged")
    exe = ExecutableRegistry().pull(PayloadImage(arch, "smoke", "serve"), CPU)
    eng = exe.fn(exe.make_inputs(0), slots=2, max_len=64)
    assert eng.cfg.attn_impl == "chunked" and eng.kv == stats["kv"]


def test_via_pilots_binds_the_papers_pair():
    """One pilot late-binds smollm-360m, then gemma-2b (prefetched), as
    examples/late_binding_serve.py's pair: both exit 0, every request
    completes, the second bind is a cache hit."""
    out = serve_via_pilots(["smollm-360m", GEMMA], n_requests=3, smoke=True,
                           device=CPU, slots=2, max_len=64)
    assert out["drained"]
    assert [p["exitcode"] for p in out["payloads"]] == [0, 0]
    assert [p["serve"]["completed"] for p in out["payloads"]] == [3, 3]
    assert out["payloads"][1]["bind_cached"] is True
    assert out["registry"]["prefetches"] == 1
