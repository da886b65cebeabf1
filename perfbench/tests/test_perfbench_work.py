"""The yardstick's counts against hand counts at two shapes each."""

import pytest

from perfbench import work

GRANITE = {"family": "moe", "num_hidden_layers": 2, "hidden_size": 8,
           "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 2,
           "num_local_experts": 4, "num_experts_per_tok": 2,
           "intermediate_size": 3, "vocab_size": 10}
MAMBA = {"family": "ssm", "num_hidden_layers": 3, "hidden_size": 4,
         "state_size": 2, "head_dim": 2, "expand": 2, "conv_kernel": 4,
         "chunk_size": 2, "n_groups": 1, "vocab_size": 10}


@pytest.mark.parametrize("c, per_layer", [
    # q 8x8, k and v 8x4 each, o 8x8: 2*(64+32+32+64); router 2*8*4;
    # 2 experts of 3 products 8x3: 2*3*2*24
    (GRANITE, 2 * (64 + 32 + 32 + 64) + 2 * 32 + 2 * 3 * 2 * 24),
    # d_inner 8, H 4, conv_dim 12, in_dim 8+12+4 = 24: in 2*4*24, out
    # 2*8*4, conv 2*4*12, state 6*4*2*2
    (MAMBA, 2 * 4 * 24 + 2 * 8 * 4 + 2 * 4 * 12 + 6 * 4 * 2 * 2),
])
def test_token_flops(c, per_layer):
    assert work.token_flops(c) == c["num_hidden_layers"] * per_layer


@pytest.mark.parametrize("n", [1, 37])
def test_decode_flops(n):
    att = 2 * 4 * 4 * 2 * n                      # L * 4 * H * Dh * n
    assert work.decode_flops(GRANITE, n) == (work.token_flops(GRANITE) + att
                                             + 2 * 8 * 10)
    assert work.decode_flops(MAMBA, n) == work.token_flops(MAMBA) + 2 * 4 * 10


@pytest.mark.parametrize("S", [1, 5])
def test_prefill_flops_attention(S):
    pairs = S * (S + 1) // 2
    assert work.prefill_flops(GRANITE, S) == (
        S * work.token_flops(GRANITE) + 2 * 8 * 10 + 2 * 4 * 4 * 2 * pairs)


@pytest.mark.parametrize("n, want_bytes", [
    # per layer: n rows of K and V (2 heads of 2, bf16) + q and out (4x2)
    (1, 2 * (2 * 1 * 2 * 2 * 2 + 2 * 4 * 2 * 2)),
    (100, 2 * (2 * 100 * 2 * 2 * 2 + 2 * 4 * 2 * 2)),
])
def test_paged_decode_work(n, want_bytes):
    nbytes, flops = work.paged_decode_work(GRANITE, n)
    assert nbytes == want_bytes
    assert flops == 2 * 4 * 4 * 2 * n


@pytest.mark.parametrize("S, Q, chunks", [(4, 2, [2, 2]), (5, 4, [4, 1])])
def test_ssd_work(S, Q, chunks):
    b, H, P, G, N = 1, 3, 2, 1, 5
    nbytes, flops, tc = work.ssd_work(b, S, H, P, G, N, Q, 2)
    assert nbytes == (2 * S * H * P * 2 + S * H * 4 + H * 4
                      + 2 * S * G * N * 2 + H * N * P * 4)
    cb = sum(2 * (q * (q + 1) // 2) * N * G for q in chunks)
    ph = sum(H * (2 * (q * (q + 1) // 2) * P + 4 * q * N * P) for q in chunks)
    assert (flops, tc) == (cb + ph, cb + 2 * ph)


def test_steps_in_counts_decode_steps_only():
    row = {"plen": 16}
    # token 1 comes from the admission; the step making token j+1 sees
    # 16 + j rows
    assert list(work.steps_in(row, 0, 4)) == [17, 18, 19]
    assert list(work.steps_in(row, 2, 4)) == [18, 19]
    assert list(work.steps_in(row, 4, 4)) == []


def test_bound_picks_the_larger_term():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 989e12) == pytest.approx(1.0)
