"""The port's configs, layers and host-side serving helpers against the JAX
package's.

Inputs are made with numpy from a seed and handed to both packages.  The
layer math is compared in float32 where the point is the algorithm
(rtol=atol=1e-5: the same f32 ops in another library) and in bf16 where the
reference computes in bf16 (rtol=atol=2e-2: one or two bf16 ulps after a
product summed in another order).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_smoke_config as jax_get_smoke
from repro.launch.serve import make_trace as jax_make_trace
from repro.models import layers as jl
from repro.serving.blockpool import BlockAllocator as JaxAllocator
from repro.serving.blockpool import PrefixCache as JaxPrefix
from repro.serving.engine import admit_buckets as jax_buckets
from repro.serving.engine import admit_length as jax_admit_length
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.launch.serve import make_trace
from repro_torch.models import layers as tl
from repro_torch.serving.blockpool import BlockAllocator, PrefixCache
from repro_torch.serving.engine import admit_buckets, admit_length

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def _bf16(a):
    """numpy f32 -> (torch bf16, jax bf16) with identical values."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    mine = (get_smoke_config if smoke else get_config)("smollm-360m")
    ref = (jax_get_smoke if smoke else jax_get_config)("smollm-360m")
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()


def test_full_config_widths():
    cfg = get_config("smollm-360m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (32, 960, 15, 5, 64,
                                                         2560, 49152)
    assert cfg.tie_embeddings and cfg.mlp_gated and cfg.norm == "rmsnorm"


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_norm_matches_reference(impl, dtype, norm):
    """RMSNorm: ``1 + scale`` in f32, variance in f32; both the plain path
    and the fused kernel's path (norm_impl="pallas").  LayerNorm (the
    starcoder2 arch): mean and variance in f32, ``scale`` and ``bias`` as
    they are, whatever ``norm_impl`` says."""
    arch = "smollm-360m" if norm == "rmsnorm" else "starcoder2-3b"
    cfg = dataclasses.replace(get_smoke_config(arch), norm_impl=impl)
    jcfg = dataclasses.replace(jax_get_smoke(arch), norm_impl=impl)
    assert cfg.norm == jcfg.norm == norm
    x = _rand((2, 7, cfg.d_model), 0)
    p = {"scale": _rand((cfg.d_model,), 1, 0.1)}
    if norm == "layernorm":
        p = {"scale": 1 + p["scale"], "bias": _rand((cfg.d_model,), 2, 0.1)}
    if dtype == "bf16":
        xt, xj = _bf16(x)
        tol = BF16_TOL
    else:
        xt, xj, tol = torch.from_numpy(x), jnp.asarray(x), F32_TOL
    out = tl.apply_norm(xt, {k: torch.from_numpy(v) for k, v in p.items()},
                        cfg)
    ref = jl.apply_norm(xj, {k: jnp.asarray(v) for k, v in p.items()}, jcfg)
    assert out.dtype == xt.dtype
    np.testing.assert_allclose(_f(out), _f(ref), **tol)


@pytest.mark.parametrize("pos_shape", ["seq", "per_row"])
def test_rope_matches_reference(pos_shape):
    """Half-split (not interleaved) RoPE with (S, d/2) or per-row
    (B, S, d/2) tables."""
    rng = np.random.default_rng(2)
    B, S, H, Dh = 3, 5, 4, 20
    if pos_shape == "seq":
        pos = np.arange(S, dtype=np.int32)
    else:
        pos = rng.integers(0, 1000, size=(B, S)).astype(np.int32)
    ct, st = tl.rope_table(torch.from_numpy(pos), Dh, 10_000.0)
    cj, sj = jl.rope_table(jnp.asarray(pos), Dh, 10_000.0)
    np.testing.assert_allclose(_f(ct), _f(cj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_f(st), _f(sj), rtol=1e-4, atol=1e-4)
    x = _rand((B, S, H, Dh), 3)
    xt, xj = _bf16(x)
    out = tl.apply_rope(xt, ct, st)
    ref = jl.apply_rope(xj, cj, sj)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f(out), _f(ref), **BF16_TOL)


@pytest.mark.parametrize("activation,gated", [("silu", True), ("gelu", True),
                                              ("gelu", False)])
def test_apply_mlp_matches_reference(activation, gated):
    """SwiGLU / GeGLU / plain MLP; gelu is the tanh approximation."""
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"),
                              activation=activation, mlp_gated=gated)
    jcfg = dataclasses.replace(jax_get_smoke("smollm-360m"),
                               activation=activation, mlp_gated=gated)
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"up": _rand((D, Fd), 4, D ** -0.5), "down": _rand((Fd, D), 5, Fd ** -0.5)}
    if gated:
        p["gate"] = _rand((D, Fd), 6, D ** -0.5)
    xt, xj = _bf16(_rand((2, 3, D), 7))
    out = tl.apply_mlp(xt, {k: torch.from_numpy(v) for k, v in p.items()}, cfg)
    ref = jl.apply_mlp(xj, {k: jnp.asarray(v) for k, v in p.items()}, jcfg)
    np.testing.assert_allclose(_f(out), _f(ref), **BF16_TOL)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    import jax
    np.testing.assert_allclose(_f(tl.act_fn("gelu")(torch.from_numpy(x))),
                               _f(jax.nn.gelu(jnp.asarray(x))), **F32_TOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_lm_logits_and_embed_match_reference(softcap):
    V, D = 64, 24
    table = _rand((V, D), 8, 0.5)
    tokens = np.random.default_rng(9).integers(0, V, size=(2, 5)).astype(np.int32)
    xt = tl.embed_lookup(torch.from_numpy(tokens), torch.from_numpy(table))
    xj = jl.embed_lookup(jnp.asarray(tokens), jnp.asarray(table))
    np.testing.assert_array_equal(_f(xt), _f(xj))
    head = _rand((D, V), 10)
    out = tl.lm_logits(xt, torch.from_numpy(head), softcap)
    ref = jl.lm_logits(xj, jnp.asarray(head), softcap)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_f(out), _f(ref), **BF16_TOL)


def test_dense_and_embed_init_statistics():
    """torch's generator cannot give jax.random's numbers; the inits match
    in law: truncation at 2 sigma with sigma = 1/sqrt(fan_in), N(0, 0.02)."""
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, (400, 300))
    assert float(w.abs().max()) <= 2.0 / 400 ** 0.5 + 1e-6
    assert abs(float(w.std()) * 400 ** 0.5 - 0.88) < 0.02    # truncated std
    e = tl.embed_init(gen, (500, 200))
    assert abs(float(e.std()) - 0.02) < 1e-3
    again = tl.dense_init(torch.Generator().manual_seed(0), (400, 300))
    assert torch.equal(w, again)


# ---------------------------------------------------------------------------
# host-side serving helpers (the port's copies)
# ---------------------------------------------------------------------------

def test_admission_buckets_match_reference():
    for max_len in (32, 96, 1024):
        assert admit_buckets(max_len) == jax_buckets(max_len)
        for n in range(1, max_len):
            assert admit_length(n, max_len) == jax_admit_length(n, max_len)
    with pytest.raises(ValueError, match="admission cap"):
        admit_length(1024, 1024)


def test_make_trace_matches_reference():
    for seed in (0, 3):
        assert make_trace(512, 9, max_len=96, seed=seed, dup_rate=0.3) == \
            jax_make_trace(512, 9, max_len=96, seed=seed, dup_rate=0.3)
    tr = make_trace(49152, 16, max_len=1024, prompt_len=(24, 900),
                    max_new_tokens=64)
    assert all(24 <= len(e["prompt"]) <= 900 and e["max_new_tokens"] == 64
               for e in tr)


def test_block_allocator_and_prefix_cache_match_reference():
    """Drive both copies through the same operations: same ids, same
    refcounts, same prefix hits, same evictions."""
    rng = np.random.default_rng(11)
    mine, ref = BlockAllocator(9, 4), JaxAllocator(9, 4)
    pm, pr = PrefixCache(mine), JaxPrefix(ref)
    prompt = rng.integers(0, 50, size=16).astype(np.int32)
    keys = PrefixCache.block_keys(prompt, 4, 4)
    assert keys == JaxPrefix.block_keys(prompt, 4, 4)
    got = [mine.alloc() for _ in range(4)]
    assert got == [ref.alloc() for _ in range(4)]
    for k, b in zip(keys[:3], got):
        pm.publish(k, b)
        pr.publish(k, b)
    assert pm.match(keys) == pr.match(keys)
    for b in got:
        mine.free(b)
        ref.free(b)
    assert [mine.refcount(b) for b in range(9)] == \
        [ref.refcount(b) for b in range(9)]
    assert pm.evict_unreferenced(10) == pr.evict_unreferenced(10)
    assert mine.allocated_blocks == ref.allocated_blocks
    b = mine.alloc()
    mine.free(b)
    with pytest.raises(RuntimeError, match="underflow"):
        mine.free(b)
