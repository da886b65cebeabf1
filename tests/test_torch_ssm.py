"""The port's Mamba-2 slice against the JAX package: the SSD-scan kernel
module, the SSM mixer (chunked scan, prefill with its decode cache, O(1)
decode), and mamba2-370m's smoke model, bridged, through prefill, dense
decode and the serve engine.

Inputs are made with numpy from a seed and handed to both packages; the
parameters are the reference's own (``init_ssm`` / ``build_model(cfg).init``
with a ``jax.random`` key), bridged (matrices and conv weights bf16;
``A_log``, ``dt_bias``, ``D_skip``, ``norm_scale`` and the norm scales
f32).  On the CPU the port's kernel wrapper runs its plain version; the
JAX SSD scan runs in Pallas interpret mode, as tests/test_kernels.py runs
it.

Tolerances, and why:

* SSD scan: 1e-3 for f32 inputs and 6e-2 for bf16, those of
  tests/test_kernels.py for the same function (f32 sums in another
  order; bf16 y rounded once on each side).
* ``ssd_chunked``: rtol = atol = 2e-4, that of the reference's own
  chunk-size invariance test (the same f32 math in another order).
* Mixer outputs and model logits: rtol = atol = 1e-2, that of
  tests/test_torch_model.py.  Outputs are bf16 (one ulp at |y| in [1, 2)
  is 7.8e-3) and both packages round at the same points: the conv chain,
  ``x * sigmoid(x)``, the kernel path's bf16 y before the D skip; they sum
  in other orders.  The f32 SSD state: rtol = atol = 1e-2 (its inputs are
  those bf16 activations).
* Prefill-then-decode against a longer prefill: rtol = atol = 0.1, that of
  tests/test_models_math.py::test_ssm_prefill_state_matches_decode.
* Inside the port: a request's stream alone and among others, bitwise.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.configs.base import get_smoke_config as jax_smoke
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.models import ssm as jssm
from repro.models.api import build_model as jax_build
from repro.models.api import init_decode_state as jax_state
from repro.serving.engine import ServeEngine as JaxEngine
from repro.serving.engine import _install_slot as jax_install
from repro.serving.engine import make_engine_step as jax_make_step
from repro.serving.engine import spec_ineligible_reason as jax_spec_reason
from repro_torch.bridge import F32_LEAVES, params_from_numpy, params_to_numpy
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.kernels.ssd_scan.ops import (
    KERNEL_CHUNK, chunk_for, ssd_scan, ssd_scan_plain)
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import _on_kernels, make_trace
from repro_torch.models import ssm
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.serving.engine import Request, ServeEngine, _install_slot

ARCH = "mamba2-370m"
TOL = dict(rtol=1e-2, atol=1e-2)
KERNELS = dict(ssm_impl="pallas", norm_impl="pallas")
MARGIN = 2e-2


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(**kw):
    return (dataclasses.replace(get_smoke_config(ARCH), **kw),
            dataclasses.replace(jax_smoke(ARCH), **kw))


def _pair(a, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return t, jnp.asarray(t.numpy())


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_copies_the_reference(smoke):
    mine = (get_smoke_config if smoke else get_config)(ARCH)
    ref = (jax_smoke if smoke else jax_config)(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    if smoke:
        assert (mine.d_model, mine.ssm.state_dim, mine.ssm.head_dim,
                mine.ssm.chunk_size) == (64, 16, 16, 32)


# ---------------------------------------------------------------------------
# the SSD scan: the kernel module against the JAX package
# ---------------------------------------------------------------------------

def _scan_inputs(b, S, H, P, G, N, dtype, seed=10):
    """tests/test_kernels.py's recipe, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, S, H, P))
    dt = np.log1p(np.exp(rng.normal(size=(b, S, H))))
    A = -np.exp(rng.normal(size=(H,)) * 0.5)
    B = rng.normal(size=(b, S, G, N)) * 0.3
    C = rng.normal(size=(b, S, G, N)) * 0.3
    pairs = [_pair(x, dtype), _pair(dt, "f32"), _pair(A, "f32"),
             _pair(B, dtype), _pair(C, dtype)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,dtype", [
    (2, 256, 4, 64, 1, 128, 64, "f32"),
    (1, 192, 8, 32, 2, 64, 64, "f32"),          # grouped B/C
    (2, 128, 2, 64, 1, 128, 128, "f32"),        # single chunk
    (1, 100, 4, 32, 1, 64, 32, "f32"),          # padding
    (1, 100, 8, 16, 1, 16, 32, "bf16"),         # the smoke mixer's widths
])
def test_ssd_scan_matches_jax(b, S, H, P, G, N, chunk, dtype):
    """The four cases of tests/test_kernels.py::test_ssd_scan_sweep and a
    bf16 one: the plain version and the wrapper's CPU path against the JAX
    wrapper (Pallas interpret mode) and the sequential oracle."""
    mine, ref = _scan_inputs(b, S, H, P, G, N, dtype)
    jy, js = jax_ssd_scan(*ref, chunk=chunk)
    oy, os_ = ssd_scan_ref(*ref)
    tol = 1e-3 if dtype == "f32" else 6e-2
    before = ssd_scan.launches
    for y, st in (ssd_scan_plain(*mine, chunk=chunk),
                  ssd_scan(*mine, chunk=chunk)):
        assert y.dtype == mine[0].dtype and y.shape == (b, S, H, P)
        assert st.dtype == torch.float32 and st.shape == (b, H, N, P)
        for want_y, want_s in ((jy, js), (oy, os_)):
            np.testing.assert_allclose(_f(y), _f(want_y), rtol=tol, atol=tol)
            np.testing.assert_allclose(_f(st), _f(want_s), rtol=tol, atol=tol)
    assert ssd_scan.launches == before                # CPU: no kernel


@pytest.mark.parametrize("S,chunk", [(1023, 256), (512, 256), (100, 32),
                                     (32, 256), (100, 128), (256, 64)])
def test_chunk_choice_matches_reference(S, chunk):
    """``chunk`` when it divides S, else min(chunk, S): the reference
    wrapper's rule (1023 -> 256 with one padded step; 32 -> 32)."""
    want = min(chunk, S) if S % chunk else chunk
    assert chunk_for(S, chunk) == want


def test_ssd_scan_refuses_bad_shapes_and_devices():
    mine, _ = _scan_inputs(1, 8, 2, 4, 1, 4, "f32")
    x, dt, A, B, C = mine
    with pytest.raises(ValueError, match="H % G"):
        ssd_scan(x, dt, A, B.expand(1, 8, 3, 4), C.expand(1, 8, 3, 4))
    with pytest.raises(ValueError, match="no kernel"):
        ssd_scan(*(t.to("meta") for t in mine))


def _split_bf16(v):
    """v ~ hi + lo, both bf16 values (held as f32), as the kernel splits an
    f32 operand."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _passes(eq, a, b, split_a, split_b):
    """The product ``einsum(eq, a, b)`` as the kernel's tensor-core passes
    compute it: a split operand is hi + lo, an exact one (bf16 already) is
    used as it is; hi.hi, then hi.lo and lo.hi where there is a lo, each
    summed in f32 (the lo.lo term is dropped)."""
    ah, al = _split_bf16(a) if split_a else (a, None)
    bh, bl = _split_bf16(b) if split_b else (b, None)
    out = torch.einsum(eq, ah, bh)
    if bl is not None:
        out = out + torch.einsum(eq, ah, bl)
    if al is not None:
        out = out + torch.einsum(eq, al, bh)
    return out


def _ssd_by_kernel_decomposition(x, dt, A, B, C, chunk):
    """The SSD scan as csrc/ssd_scan.cu decomposes it, in plain PyTorch:
    on chunks of at most KERNEL_CHUNK steps, each chunk's own end state,
    the state entering each chunk passed along from them, the carry-in and
    the causal intra-chunk term, every f32 operand of a product split into
    bf16 hi + lo (x, B and C too for f32 inputs; they are exact for bf16
    inputs)."""
    sp = x.dtype == torch.float32
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk_for(S, chunk), KERNEL_CHUNK)
    nc = -(-S // Q)
    pad = nc * Q - S
    xc = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(
        b, nc, Q, H, P)
    dtc = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad)).reshape(
        b, nc, Q, H)
    Bc, Cc = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
              .reshape(b, nc, Q, G, N).repeat_interleave(H // G, dim=3)
              for t in (B, C))                                 # (b,nc,Q,H,N)
    cum = torch.cumsum(dtc * A.float(), dim=2)                 # (b,nc,Q,H)
    tot = cum[:, :, -1]                                        # (b,nc,H)
    # launch 1: each chunk's own end state
    w = dtc * torch.exp(tot[:, :, None] - cum)
    s_loc = _passes("bcjhn,bcjhp->bchnp", Bc, xc * w[..., None], sp, True)
    # launch 2: the state entering each chunk
    s_in = torch.zeros_like(s_loc)
    for c in range(1, nc):
        s_in[:, c] = (torch.exp(tot[:, c - 1])[..., None, None]
                      * s_in[:, c - 1] + s_loc[:, c - 1])
    # launch 3: carry-in and intra-chunk term
    carry = (_passes("bcqhn,bchnp->bcqhp", Cc, s_in, sp, True)
             * torch.exp(cum)[..., None])
    cb = _passes("bcqhn,bcjhn->bchqj", Cc, Bc, sp, sp)
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).permute(
        0, 1, 4, 2, 3)
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    m = (cb * torch.exp(seg.masked_fill(~causal, float("-inf")))
         * dtc.permute(0, 1, 3, 2)[:, :, :, None, :])          # (b,nc,H,q,j)
    intra = _passes("bchqj,bcjhp->bcqhp", m, xc, True, sp)
    y = (intra + carry).reshape(b, nc * Q, H, P)[:, :S]
    final = torch.exp(tot[:, -1])[..., None, None] * s_in[:, -1] + s_loc[:, -1]
    return y.to(x.dtype), final


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,S,H,P,G,N,chunk", [
    (2, 256, 4, 64, 1, 128, 64),
    (1, 192, 8, 32, 2, 64, 64),          # grouped B/C
    (2, 128, 2, 64, 1, 128, 128),        # single chunk
    (1, 100, 4, 32, 1, 64, 32),          # padding
    (1, 1023, 2, 64, 1, 128, 256),       # the 1023 admission's chunking
    (1, 300, 4, 32, 2, 64, 128),         # grouped and padded
])
def test_kernel_decomposition_holds_the_scan_tolerances(b, S, H, P, G, N,
                                                        chunk, dtype):
    """The kernel's decomposition and hi + lo splits (two passes per f32
    operand, three with f32 x, B and C) against the JAX package's
    sequential oracle, at the tolerances of tests/test_kernels.py: the
    numerics of csrc/ssd_scan.cu, shown without a card."""
    mine, ref = _scan_inputs(b, S, H, P, G, N, dtype)
    y, st = _ssd_by_kernel_decomposition(*mine, chunk)
    oy, os_ = ssd_scan_ref(*ref)
    tol = 1e-3 if dtype == "f32" else 6e-2
    np.testing.assert_allclose(_f(y), _f(oy), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f(st), _f(os_), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the SSM mixer
# ---------------------------------------------------------------------------

def _bridge_mixer(jp):
    """One layer's reference parameters as the bridge stores them."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k in F32_LEAVES else torch.bfloat16)
        for k, v in jp.items()}


@pytest.fixture(scope="module")
def mixer_params():
    _, jcfg = _cfgs()
    jp = jssm.init_ssm(jax.random.key(3), jcfg)
    return jp, _bridge_mixer(jp)


def test_ssd_chunked_matches_jax():
    """The pure chunked path in f32, chunk 32 over 100 steps (padded)."""
    mine, ref = _scan_inputs(2, 100, 4, 16, 1, 16, "f32", seed=4)
    y, st = ssm.ssd_chunked(*mine, 32)
    jy, js = jssm.ssd_chunked(*ref, 32)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(_f(y), _f(jy), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_f(st), _f(js), rtol=2e-4, atol=2e-4)


def _hidden(seed, shape, scale=0.5):
    return _pair(np.random.default_rng(seed).normal(size=shape) * scale,
                 "bf16")


@pytest.mark.parametrize("ssm_impl", ["chunked", "pallas"])
@pytest.mark.parametrize("S", [50, 2])       # 2 < W-1: the padded conv tail
def test_ssm_forward_with_cache_matches_jax(mixer_params, ssm_impl, S):
    """Out, the conv tail and the SSD state against the reference's, each
    path against its own (pallas rounds y to bf16 before the D skip)."""
    cfg, jcfg = _cfgs(ssm_impl=ssm_impl)
    jp, p = mixer_params
    x, xj = _hidden(0, (2, S, cfg.d_model))
    out, cache = ssm.ssm_forward_with_cache(x, p, cfg)
    jout, jcache = jssm.ssm_forward_with_cache(xj, jp, jcfg)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssd"].dtype == torch.float32
    np.testing.assert_allclose(_f(out), _f(jout), **TOL)
    np.testing.assert_allclose(_f(cache["conv"]), _f(jcache["conv"]), **TOL)
    np.testing.assert_allclose(_f(cache["ssd"]), _f(jcache["ssd"]), **TOL)
    np.testing.assert_allclose(_f(ssm.ssm_forward(x, p, cfg)), _f(out),
                               rtol=0, atol=0)


def test_ssm_decode_matches_jax_and_writes_in_place(mixer_params):
    """Three decode steps from a prefilled cache: each output and the
    cache the reference returns, with the port's cache rows updated in
    place."""
    cfg, jcfg = _cfgs()
    jp, p = mixer_params
    x, xj = _hidden(1, (3, 20, cfg.d_model))
    _, cache = ssm.ssm_forward_with_cache(x, p, cfg)
    _, jcache = jssm.ssm_forward_with_cache(xj, jp, jcfg)
    conv, ssd = cache["conv"], cache["ssd"]
    for t in range(3):
        tok, tokj = _hidden(10 + t, (3, 1, cfg.d_model))
        out, cache = ssm.ssm_decode(tok, p, cfg, cache)
        jout, jcache = jssm.ssm_decode(tokj, jp, jcfg, jcache)
        assert cache["conv"] is conv and cache["ssd"] is ssd
        np.testing.assert_allclose(_f(out), _f(jout), **TOL)
        np.testing.assert_allclose(_f(conv), _f(jcache["conv"]), **TOL)
        np.testing.assert_allclose(_f(ssd), _f(jcache["ssd"]), **TOL)


def test_ssm_prefill_state_matches_decode(mixer_params):
    """The port's mirror of tests/test_models_math.py: prefill over S
    tokens then one decode step equals a prefill over S+1 tokens at the
    last position (state-carry correctness), on both scan paths."""
    _, p = mixer_params
    for impl in ("chunked", "pallas"):
        cfg, _ = _cfgs(ssm_impl=impl)
        S = 24
        x, _ = _hidden(36, (1, S + 1, cfg.d_model))
        out_full, _ = ssm.ssm_forward_with_cache(x, p, cfg)
        _, cache = ssm.ssm_forward_with_cache(x[:, :S], p, cfg)
        out_step, _ = ssm.ssm_decode(x[:, S:S + 1], p, cfg, cache)
        np.testing.assert_allclose(_f(out_step[:, 0]), _f(out_full[:, S]),
                                   rtol=0.1, atol=0.1)


def test_port_init_matches_the_reference_constants():
    """The port's own init: A_log, D_skip, dt_bias and norm_scale are the
    reference's deterministic values (f32), the matrices bf16 and seeded;
    the stacked leaves have a leading n_groups = num_layers dim."""
    cfg, jcfg = _cfgs()
    params = build_model(cfg).init(0, device="cpu")
    mixer = params.layers[0]["mixer"]
    jp = jssm.init_ssm(jax.random.key(0), jcfg)
    for k in ("A_log", "D_skip", "dt_bias", "norm_scale"):
        assert mixer[k].dtype == torch.float32
        for g in range(cfg.num_layers):
            np.testing.assert_allclose(_f(mixer[k][g]), _f(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    for k in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert mixer[k].dtype == torch.bfloat16
        assert tuple(mixer[k].shape) == (cfg.num_layers,) + jp[k].shape
    assert "ffn" not in params.layers[0] and "ffn_norm" not in params.layers[0]


def test_serve_entry_runs_the_kernels():
    cfg = _on_kernels(get_config(ARCH))
    assert (cfg.ssm_impl, cfg.norm_impl) == ("pallas", "pallas")


def test_hybrid_and_verify_are_later_slices():
    """A hybrid stack (SSM + attention layers) builds (tests/test_torch_hybrid.py
    holds jamba to the reference), and neither it nor an SSM model has a
    verify forward (SSM state cannot roll back)."""
    cfg, _ = _cfgs()
    hybrid = dataclasses.replace(cfg, num_heads=4, num_kv_heads=2,
                                 attn_period=2)
    hb = build_model(hybrid)
    hstate = init_decode_state(hybrid, 2, 32, kv="paged", device="cpu")
    with pytest.raises(ValueError, match="SSM state rows"):
        hb.verify(hb.init(0, device="cpu"),
                  torch.zeros((2, 3), dtype=torch.int32), hstate)
    bundle = build_model(cfg)
    params = bundle.init(0, device="cpu")
    state = init_decode_state(cfg, 2, 32, kv="dense", device="cpu")
    with pytest.raises(ValueError, match="SSM state rows"):
        bundle.verify(params, torch.zeros((2, 3), dtype=torch.int32), state)


# ---------------------------------------------------------------------------
# the model: bridge, prefill + teacher-forced dense decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_tree():
    _, jcfg = _cfgs(**KERNELS)
    return jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(0)))


def test_bridge_keeps_the_ssm_leaves_f32(ref_tree):
    """A_log, dt_bias, D_skip and norm_scale stay f32 and come back bit for
    bit; conv_w and conv_b are stored bf16, as the reference casts them at
    use."""
    cfg, _ = _cfgs(**KERNELS)
    params = params_from_numpy(ref_tree, cfg, device="cpu")
    mixer = params.layers[0]["mixer"]
    back = params_to_numpy(params)["layers"][0]["mixer"]
    for k in ("A_log", "dt_bias", "D_skip", "norm_scale"):
        assert mixer[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k], ref_tree["layers"][0]["mixer"][k])
    for k in ("conv_w", "conv_b", "in_proj", "out_proj"):
        assert mixer[k].dtype == torch.bfloat16
    assert params.layers[0]["mixer_norm"]["scale"].dtype == torch.float32


SLOTS, MAX_LEN = 2, 64
PROMPTS = [(0, 23), (1, 9)]                 # (slot, prompt length)


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


def _run_port(cfg, tree, steps, forced):
    bundle = build_model(cfg)
    params = params_from_numpy(tree, cfg, device="cpu")
    state = init_decode_state(cfg, SLOTS, MAX_LEN, kv="dense", device="cpu")
    prefill_logits, out = [], []
    for (slot, _n), toks in zip(PROMPTS, forced["prompts"]):
        lg, cache = bundle.prefill(params, {"tokens": torch.from_numpy(toks[None])})
        prefill_logits.append(_f(lg[0, -1]))
        _install_slot(state, cache, slot, len(toks), 0)
    for t in range(steps):
        state["token"] = torch.from_numpy(forced["decode"][t][:, None].copy())
        logits, state = bundle.decode(params, state)
        out.append(_f(logits[:, 0]))
    return np.stack(prefill_logits), np.stack(out), state


def _run_jax(jcfg, tree, steps, forced):
    bundle = jax_build(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    state = jax_state(jcfg, SLOTS, MAX_LEN, kv="dense")
    prefill = jax.jit(bundle.prefill)
    prefill_logits, out = [], []
    for (slot, _n), toks in zip(PROMPTS, forced["prompts"]):
        logits, cache = prefill(params, {"tokens": jnp.asarray(toks[None])})
        prefill_logits.append(_f(logits[0, -1]))
        state = jax_install(state, cache, slot, len(toks), 0)
    decode = jax.jit(bundle.decode)
    for t in range(steps):
        state = {**state, "token": jnp.asarray(forced["decode"][t][:, None])}
        logits, state = decode(params, state)
        out.append(_f(logits[:, 0]))
    return np.stack(prefill_logits), np.stack(out), state


def test_slice_logits_match_jax(ref_tree):
    """Prefill of two left-padded prompts (the SSD scan through its kernel
    wrapper) plus 8 teacher-forced dense decode steps: the port's logits
    and final per-row SSM state match the reference's, with the kernel
    paths (ssm/norm "pallas") selected on both sides."""
    cfg, jcfg = _cfgs(**KERNELS)
    forced = _forced(cfg.vocab_size, 8)
    pp, pd, state = _run_port(cfg, ref_tree, 8, forced)
    jp, jd, jstate = _run_jax(jcfg, ref_tree, 8, forced)
    np.testing.assert_allclose(pp, jp, **TOL)
    np.testing.assert_allclose(pd, jd, **TOL)
    assert set(state["cache"][0]) == {"conv", "ssd"}
    np.testing.assert_allclose(_f(state["cache"][0]["ssd"]),
                               _f(jstate["cache"][0]["ssd"]), **TOL)
    np.testing.assert_array_equal(state["pos"].numpy(),
                                  np.asarray(jstate["pos"]))


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_model():
    cfg, jcfg = _cfgs(**KERNELS)
    jparams = jax_build(jcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return cfg, jcfg, params, jparams


def _margin(row):
    top = np.sort(np.asarray(row, np.float32))[-2:]
    return float(top[1] - top[0])


def test_engine_token_streams_match_jax(engine_model, record_property):
    """An 8-request trace through both engines (2 slots, max_len 64, both
    on the dense layout): streams compared up to each request's first
    position whose JAX top-2 logit margin is below 2e-2
    (tests/test_torch_engine.py's rule); one transfer per step."""
    cfg, jcfg, params, jparams = engine_model
    trace = make_trace(cfg.vocab_size, 8, max_len=64, seed=0)
    port = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    port.run_trace(trace)
    assert port.kv == "dense" and port.d2h_transfers == port.steps

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
    assert jeng.kv == "dense"
    compared = 0
    for rid, jreq in jeng.done.items():
        mine = port.done[rid].tokens
        assert len(mine) == len(jreq.tokens) == len(margins[rid])
        n = next((j for j, m in enumerate(margins[rid]) if m < MARGIN),
                 len(mine))
        assert mine[:n] == jreq.tokens[:n], (rid, n)
        compared += n
    record_property("positions_compared", compared)
    assert compared > 0


@pytest.mark.parametrize("kv", [None, "paged"])
def test_engine_is_dense_and_spec_falls_back(engine_model, kv):
    """An attention-free arch serves on the dense layout whatever ``kv``
    asks (its SSM state has nothing to page), and ``spec="draft"`` serves
    with speculation off, recording the reference's reason."""
    cfg, jcfg, params, _ = engine_model
    eng = ServeEngine(cfg, params, slots=2, max_len=64, kv=kv, spec="draft",
                      device="cpu")
    assert eng.kv == "dense" and eng.spec == "off"
    assert eng.spec_fallback_reason == jax_spec_reason(jcfg, "dense")
    assert eng.spec_fallback_reason is not None
    assert eng.block_leaks() == 0
    assert set(eng.state["cache"][0]) == {"conv", "ssd"}
    assert "block_tables" not in eng.state


def _req(rid, plen, max_new, vocab):
    rng = np.random.default_rng(rid)
    return Request(rid=rid, prompt=rng.integers(0, vocab, size=plen)
                   .astype(np.int32), max_new_tokens=max_new)


def test_slot_isolation_bitwise(engine_model):
    """A request's tokens are identical solo and beside other requests,
    one of them admitted mid-decode into the other slot: admission writes
    the slot's conv and ssd rows whole and touches no other row."""
    cfg, _, params, _ = engine_model
    V = cfg.vocab_size
    solo = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    solo.submit(_req(0, 7, 12, V))
    solo.run()
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    eng.submit(_req(0, 7, 12, V))
    eng.submit(_req(2, 30, 3, V))
    for _ in range(5):
        eng.step()
    eng.submit(_req(1, 13, 9, V))
    eng.run()
    assert eng.done[0].tokens == solo.done[0].tokens
    assert len(eng.done[1].tokens) == 10 and len(eng.done[2].tokens) == 4
    assert eng.d2h_transfers == eng.steps


def test_serve_cli_smoke_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch mamba2-370m --smoke
    --device cpu`` answers its trace on the dense layout."""
    serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "3", "--slots", "2", "--max-len", "64"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["completed"] == 3 and stats["kv"] == "dense"
    assert stats["spec"] == "off" and stats["block_leaks"] == 0
    assert stats["d2h_transfers"] == stats["decode_steps"]
