"""Public model API of the port: ``build_model(cfg)`` -> :class:`ModelBundle`.

Port of the decoder-LM part of ``repro.models.api``:

* ``init(seed, device="cuda", dtype=bf16)`` -> :class:`LMParams`
  (frozen; ``dtype`` is that of the matrices: bf16 to serve, f32 for a
  train state's master weights)
* ``loss(params, batch)``        -> (scalar, {"ce", "aux"})   [train]
* ``prefill(params, batch)``     -> (last logits (B,1,V), dense cache)
* ``decode(params, state)``      -> (logits (B,1,V), new state)
* ``verify(params, tokens, state)`` -> (logits (B,S,V), new state)
* ``prefill_chunk(params, state, tokens, table_row, slot, q_offset)``
  -> (last logits (1,V), state): one chunk of a chunked admission into
  row ``slot`` of a paged or dense decode state

``decode`` runs on a paged state (``init_decode_state(..., kv="paged")``,
with ``block_tables``) or a dense one (``kv="dense"``); ``verify`` on a
paged state; ``prefill_chunk`` on either.  All three update the caches in
place; the JAX reference returns new arrays and its engine donates the old
ones, which is the same memory behaviour.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import COMPUTE


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device without a card
    raises: the port never moves to the CPU unless the caller asks."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:                 # "cuda" -> "cuda:<current>"
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable[..., Any]
    loss: Callable[[Any, Any], Any]
    prefill: Callable[[Any, Any], Any]
    decode: Callable[[Any, Any], Any]
    verify: Callable[[Any, Any, Any], Any]
    prefill_chunk: Callable[..., Any]


def default_num_blocks(batch: int, max_len: int, block_size: int) -> int:
    """Pool size matching a dense cache's token capacity, plus the reserved
    scratch block (id 0, the garbage sink for free slots)."""
    return batch * (max_len // block_size) + 1


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      dtype=COMPUTE, kv: str = "paged",
                      num_blocks: int | None = None, block_size: int = 16,
                      device="cuda"):
    """Zero decode state: the caches, per-row ``token`` (batch,1) and
    ``pos`` (batch,).  ``kv="paged"``: per-slot block pools plus
    ``block_tables`` (batch, max_len // block_size).  ``kv="dense"``:
    per-slot rings (n_groups, batch, max_len, K, Dh) and no tables.  SSM
    slots hold per-row state in both layouts: ``conv`` (n_groups, batch,
    W-1, conv_dim) bf16 and ``ssd`` (n_groups, batch, H, N, P) f32."""
    if kv not in ("paged", "dense"):
        raise ValueError(f"kv must be 'paged' or 'dense', got {kv!r}")
    dev = resolve_device(device)
    state = {"token": torch.zeros((batch, 1), dtype=torch.int32, device=dev),
             "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if kv == "dense":
        return {"cache": tf.init_cache(cfg, batch, max_len, dtype, dev),
                **state}
    if max_len % block_size:
        raise ValueError(f"paged KV needs max_len % block_size == 0, got "
                         f"{max_len} % {block_size}")
    nb = num_blocks or default_num_blocks(batch, max_len, block_size)
    return {
        "cache": tf.init_cache_paged(cfg, batch, max_len, nb, block_size,
                                     dtype, dev),
        **state,
        "block_tables": torch.zeros((batch, max_len // block_size),
                                    dtype=torch.int32, device=dev),
    }


def build_model(cfg: ArchConfig, compute=COMPUTE) -> ModelBundle:
    tf._check_slice(cfg)

    def init(seed: int = 0, *, device="cuda", dtype=compute):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return tf.init_lm_params(cfg, gen, dev, dtype)

    def loss(params, batch):
        return tf.lm_loss(params, cfg, batch["tokens"], batch["targets"],
                          extra_embeds=batch.get("frontend"), compute=compute)

    def prefill(params, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache = tf.init_cache(cfg, B, S, dtype=compute, device=tokens.device)
        return tf.lm_prefill(params, cfg, tokens, cache, compute=compute)

    def decode(params, state):
        logits, cache = tf.lm_decode(params, cfg, state["token"],
                                     state["cache"], state["pos"],
                                     block_tables=state.get("block_tables"),
                                     compute=compute)
        token = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return logits, {**state, "cache": cache, "token": token,
                        "pos": state["pos"] + 1}

    def verify(params, tokens, state):
        logits, cache = tf.lm_verify(params, cfg, tokens, state["cache"],
                                     state["pos"],
                                     block_tables=state.get("block_tables"),
                                     compute=compute)
        return logits, {**state, "cache": cache}

    def prefill_chunk(params, state, tokens, table_row, slot, q_offset):
        logits, _ = tf.lm_prefill_chunk(params, cfg, tokens, state["cache"],
                                        table_row, slot, q_offset,
                                        compute=compute)
        return logits, state

    return ModelBundle(cfg, init, loss, prefill, decode, verify,
                       prefill_chunk)
