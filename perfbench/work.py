"""The yardstick's counts: model operations and bytes worked out from a
configuration's published sizes, whatever implements them, and the card's
published peaks (NVIDIA H100 SXM data sheet, dense rates: 989 TFLOP/s
bf16, 3.35 TB/s HBM3, at its 700 W limit).  An FMA counts 2 operations."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _ssm_dims(c):
    d_inner = c["expand"] * c["hidden_size"]
    H = d_inner // c["head_dim"]
    G, N = c["n_groups"], c["state_size"]
    return d_inner, H, G, N, d_inner + 2 * G * N, 2 * d_inner + 2 * G * N + H


def token_flops(c: dict) -> int:
    """Operations of one token through every layer's weight products (the
    MoE's k experts and its router; the SSM's projections, conv and state
    update and read), without attention over the context or the head."""
    D, L = c["hidden_size"], c["num_hidden_layers"]
    if c["family"] == "moe":
        H, K, Dh = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        E, k, F = (c["num_local_experts"], c["num_experts_per_tok"],
                   c["intermediate_size"])
        per = 2 * D * (H + 2 * K) * Dh + 2 * H * Dh * D + 2 * D * E \
            + k * 3 * 2 * D * F
    else:
        d_inner, H, G, N, conv_dim, in_dim = _ssm_dims(c)
        P = c["head_dim"]
        per = (2 * D * in_dim + 2 * d_inner * D + 2 * c["conv_kernel"] * conv_dim
               + 6 * H * N * P)
    return L * per


def attention_flops(c: dict, n_context: int) -> int:
    """Scores and values of one query over ``n_context`` rows, every
    layer (0 for an attention-free configuration)."""
    if c["family"] != "moe":
        return 0
    return c["num_hidden_layers"] * 4 * c["num_attention_heads"] * c["head_dim"] * n_context


def head_flops(c: dict) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]


def decode_flops(c: dict, n_context: int) -> int:
    """One decode step of one request whose new token sees ``n_context``
    rows (itself included)."""
    return token_flops(c) + attention_flops(c, n_context) + head_flops(c)


def prefill_flops(c: dict, S: int) -> int:
    """One admission of a bucket of S tokens: every token's weight
    products, causal attention over S(S+1)/2 pairs (or the SSD scan on the
    model's chunk), the head at the last position."""
    f = S * token_flops(c) + head_flops(c)
    if c["family"] == "moe":
        f += c["num_hidden_layers"] * 4 * c["num_attention_heads"] \
            * c["head_dim"] * S * (S + 1) // 2
    else:
        d_inner, H, G, N, _, _ = _ssm_dims(c)
        # the scan's chunked products replace the per-token state update
        f -= S * c["num_hidden_layers"] * 6 * H * N * c["head_dim"]
        f += c["num_hidden_layers"] * ssd_work(1, S, H, c["head_dim"], G, N,
                                               c["chunk_size"], 2)[1]
    return f


def paged_decode_work(c: dict, n_context: int) -> tuple[int, int]:
    """(bytes, operations) of one decode step's attention for one request
    over ``n_context`` cached rows, every layer: each K and V row read once
    (bf16), the query read and the output written once."""
    H, K, Dh = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    L = c["num_hidden_layers"]
    nbytes = L * (2 * n_context * K * Dh * 2 + 2 * H * Dh * 2)
    return nbytes, L * 4 * H * Dh * n_context


def ssd_work(b, S, H, P, G, N, Q, itemsize):
    """Bytes (each input read once, each output written once) and
    operations of the chunked SSD scan over S steps in chunks of Q (per
    chunk: C.B^T over the causal q(q+1)/2 pairs once per group, and per
    head its product with x dt, the carry-in C.state and the state
    update); also the tensor-core operations of a bf16 instance that
    splits its f32 operands in two."""
    nbytes = (2 * b * S * H * P * itemsize + b * S * H * 4 + H * 4
              + 2 * b * S * G * N * itemsize + b * H * N * P * 4)
    cb = per_head = 0
    for t0 in range(0, S, Q):
        q = min(Q, S - t0)
        pairs = q * (q + 1) // 2
        cb += 2 * pairs * N * G
        per_head += H * (2 * pairs * P + 4 * q * N * P)
    return nbytes, b * (cb + per_head), b * (cb + 2 * per_head)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes over bandwidth or
    operations over the bf16 peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def steps_in(row: dict, p0: int, p1: int):
    """The decode steps a request made while its token count went from p0
    to p1, each as the rows its new token sees: the admission makes token
    1, the step that makes token j + 1 sees plen + j rows."""
    for j in range(max(p0, 1), p1):
        yield row["plen"] + j
