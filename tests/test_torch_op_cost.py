"""The port's step counter (``repro_torch.launch.op_cost``) against the
reference's HLO cost model.

The five cases of tests/test_hlo_cost.py in the port (an eager loop runs
every iteration, so the trip count is the count of calls); a step counts
the same on meta tensors as on CPU tensors; a smoke-width smollm-360m
prefill's products equal the analytic sum of 2*M*N*K and its total is held
to the reference's ``module_cost`` of the same prefill; and the rank
loop's transfers on a two-rank CPU mesh count as collectives under the
reference's conventions (``repro_torch.launch.op_stats``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as ref_smoke
from repro.launch.hlo_cost import module_cost
from repro.launch.steps import make_prefill_step as ref_prefill_step
from repro.models.api import build_model as ref_build
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch import op_stats
from repro_torch.launch.op_cost import step_cost
from repro_torch.launch.specs import META
from repro_torch.launch.steps import (
    init_train_state, make_prefill_step, make_serve_step, make_train_step)
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.optim.adamw import OptimConfig
from repro_torch.runtime import sharding
from repro_torch.runtime.mesh import serve_mesh

ARCH = "smollm-360m"


# ---------------------------------------------------------------------------
# the reference's five cases (tests/test_hlo_cost.py)
# ---------------------------------------------------------------------------

def test_single_matmul_exact():
    A = torch.zeros((128, 256))
    B = torch.zeros((256, 512))
    _, c = step_cost(torch.matmul, A, B)
    assert c.flops == 2 * 128 * 256 * 512
    assert c.bytes_fused == (128 * 256 + 256 * 512 + 128 * 512) * 4
    assert c.contraction_flops == {"mm": c.flops}


def test_loop_multiplies_trip_count():
    W = torch.zeros((8, 64, 64))
    x = torch.zeros((64, 64))

    def f(x, W):
        for w in W:
            x = x @ w
        return x

    _, c = step_cost(f, x, W)
    assert c.flops == 8 * 2 * 64 ** 3            # every iteration counted
    assert c.op_counts["mm"] == 8


def test_nested_loop():
    W = torch.zeros((8, 64, 64))
    x = torch.zeros((64, 64))

    def f(x, W):
        for _ in range(3):
            for w in W:
                x = x @ w
        return x

    _, c = step_cost(f, x, W)
    assert c.flops == 24 * 2 * 64 ** 3


def test_fused_bytes_exclude_elementwise_chains():
    x = torch.zeros((256, 256))

    def f(x):
        y = x @ x
        return torch.tanh(y) * 2.0 + 1.0         # fuses into the dot's output

    _, c = step_cost(f, x)
    dot_io = 3 * 256 * 256 * 4
    # fused convention: the dot's IO only; unfused counts the chain
    assert c.bytes_fused == dot_io
    assert c.bytes > c.bytes_fused
    assert c.transcendentals == 256 * 256        # tanh
    assert c.flops == 2 * 256 ** 3 + 3 * 256 * 256


def test_slice_update_counts_update_not_buffer():
    cache = torch.zeros((1024, 64))
    row = torch.zeros((1, 64))
    idx = torch.tensor([5])

    def f(cache, row):
        cache[5:6] = row                          # copy_ into a view
        cache.index_put_((idx,), row)             # index_put_
        return cache

    _, c = step_cost(f, cache, row)
    assert c.bytes_fused == 2 * (2 * 64 * 4)      # 2 x update, twice
    assert c.alias_bytes == c.output_bytes == 1024 * 64 * 4
    assert c.peak_temp_bytes < 1024              # nothing of the buffer's size


def test_layout_copies_and_gathers_count():
    x = torch.zeros((64, 32))
    table = torch.zeros((100, 32))
    ids = torch.tensor([[1, 2, 3]])

    def f(x):
        return x.t().contiguous(), table[ids], torch.cat([x, x])

    _, c = step_cost(f, x)
    n = 64 * 32 * 4
    assert c.bytes_fused == 2 * n + 2 * 3 * 32 * 4 + 2 * n


# ---------------------------------------------------------------------------
# a model step: meta == CPU; products analytic; total beside the reference
# ---------------------------------------------------------------------------

def _inputs(cfg, mode, device):
    B, S = 2, 32
    tokens = torch.zeros((B, S), dtype=torch.int32, device=device)
    if mode == "train":
        state = init_train_state(cfg, 0, device=device)
        return make_train_step(cfg, OptimConfig(total_steps=10)), (
            state, {"tokens": tokens, "targets": tokens})
    params = build_model(cfg).init(0, device=device)
    if mode == "prefill":
        return make_prefill_step(cfg), (params, {"tokens": tokens})
    state = init_decode_state(cfg, B, 64, kv="dense", device=device)
    return make_serve_step(cfg), (params, state)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", [ARCH, "mamba2-370m",
                                  "granite-moe-3b-a800m"])
def test_meta_counts_as_cpu(arch, mode):
    """One step counts the same on meta tensors as on CPU tensors.  The
    MoE router's ``F.one_hot`` is the one op that PyTorch decomposes by
    device (on a real tensor it checks the indices' range: an ``aminmax``
    and a host read; on meta it compares with an ``arange``), so for the
    MoE arch the products, the fused bytes and the memory are held
    exactly, the FLOPs and fused bytes within 0.1 % and the unfused bytes
    within 5 % (the one_hot's ops over one (B, S*k, E) int64 tensor, a
    few percent of the unfused bytes at smoke widths)."""
    cfg = get_smoke_config(arch)
    counts = []
    for device in ("cpu", META):
        step, args = _inputs(cfg, mode, device)
        _, c = step_cost(step, *args)
        counts.append(c)
    cpu, meta = counts
    for k in ("contraction_flops", "argument_bytes", "output_bytes",
              "alias_bytes", "peak_temp_bytes", "transcendentals"):
        assert getattr(cpu, k) == getattr(meta, k), k
    for k in ("flops", "bytes", "bytes_fused"):
        a, b = getattr(cpu, k), getattr(meta, k)
        if cfg.family == "moe":
            assert abs(a - b) <= (5e-2 if k == "bytes" else 1e-3) * b, k
        else:
            assert a == b, k
    if cfg.family != "moe":
        assert cpu.op_counts == meta.op_counts
    assert cpu.flops > 0


def test_prefill_products_are_analytic_and_total_near_reference():
    """The products of a smoke smollm-360m prefill (B=2, S=64) are the
    analytic sum of 2*M*N*K: per layer q/k/v/o and the MLP's three
    projections over B*S rows, the scores and the weighted sum (B, H, S,
    S, Dh) each, and the tied head at the last position.  The total
    counts the elementwise and reduce ops too, which XLA fuses and
    simplifies (casts folded, softmax rewritten) where the eager run
    dispatches each op: held within 5 % of the reference's count (0.99
    at these widths)."""
    cfg = get_smoke_config(ARCH)
    B, S = 2, 64
    D, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    F, L, V = cfg.d_ff, cfg.num_layers, cfg.vocab_size
    M = B * S
    per_layer = (2 * M * D * (H + 2 * K) * Dh + 2 * M * H * Dh * D
                 + 3 * 2 * M * D * F + 2 * 2 * B * H * S * S * Dh)
    analytic = L * per_layer + 2 * B * D * V

    ref_cfg = ref_smoke(ARCH)
    ref_params = ref_build(ref_cfg).init(jax.random.key(0))
    tokens = np.zeros((B, S), np.int32)
    hlo = jax.jit(ref_prefill_step(ref_cfg)).lower(
        ref_params, {"tokens": jnp.asarray(tokens)}).compile().as_text()
    ref_flops = module_cost(hlo).flops

    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               device="cpu")
    _, c = step_cost(make_prefill_step(cfg), params,
                     {"tokens": torch.from_numpy(tokens)})
    assert sum(c.contraction_flops.values()) == analytic
    ratio = c.flops / ref_flops
    assert abs(ratio - 1) < 0.05, ratio


# ---------------------------------------------------------------------------
# the rank loop's transfers: collectives under the reference's conventions
# ---------------------------------------------------------------------------

def test_rank_loop_gather_is_an_all_gather():
    mesh = serve_mesh((1, 2), devices=("cpu", "cpu"))
    w = torch.ones(8, 6)
    ws = sharding.split(w, sharding.Whole(w, -1, mesh.model_devices))
    x = torch.ones(3, 8)

    def step(x, ws):
        y = sharding.on_ranks(lambda a, b: a @ b, x, ws, dim=-1)
        return sharding.gather(y)

    out, c = step_cost(step, x, ws)
    assert torch.equal(out, x @ w)
    assert c.collective_counts == {"all-gather": 1, "collective-permute": 1}
    assert c.collective_bytes["all-gather"] == 3 * 6 * 4      # result bytes
    assert c.collective_bytes["collective-permute"] == 3 * 8 * 4   # x sent
    assert c.total_collective_bytes == 3 * 6 * 4 + 3 * 8 * 4
    stats = op_stats.collective_stats(c)
    assert stats["raw_bytes"]["all-gather"] == 3 * 6 * 4
    assert c.top_collectives()[0][0] == ("collective-permute",
                                         "float32[3,8]", 1)


def test_collective_conventions():
    t = torch.zeros(4, 8)
    assert op_stats.weighted_bytes("all-gather", 128) == 128
    assert op_stats.weighted_bytes("all-reduce", 128) == 256
    assert op_stats.weighted_bytes("reduce-scatter", 32, 128) == 128
    assert op_stats.weighted_bytes("all-to-all", 128) == 128
    assert op_stats.tensor_type(t) == "float32[4,8]"
    op_stats.transfer("all-gather", t)            # nobody counting: free


def test_tp_decode_step_counts_its_gathers(monkeypatch):
    """A (1, 2) CPU-mesh engine's decode step counts one all-gather, of
    the gathered bytes, per gather of the rank loop (each layer's MLP
    before its down projection, the head's logits; this smoke width's
    single KV head keeps attention whole)."""
    import repro_torch.models.attention as attn
    import repro_torch.models.layers as layers
    from repro_torch.launch.serve import build_engine
    cfg = get_smoke_config(ARCH)
    mesh = serve_mesh((1, 2), devices=("cpu", "cpu"))
    eng = build_engine(cfg, 2, 64, seed=0, device="cpu", mesh=mesh)
    gathered = []

    def gather(x):
        out = sharding.gather(x)
        if isinstance(x, sharding.Shards):
            gathered.append(out.numel() * out.element_size())
        return out
    monkeypatch.setattr(attn, "gather", gather)
    monkeypatch.setattr(layers, "gather", gather)
    _, c = step_cost(make_serve_step(cfg), eng.params, eng.state)
    assert len(gathered) >= cfg.num_layers
    assert c.collective_counts["all-gather"] == len(gathered)
    assert c.collective_bytes["all-gather"] == sum(gathered)
