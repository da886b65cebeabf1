"""Public model API of the port: ``build_model(cfg)`` -> :class:`ModelBundle`.

Port of ``repro.models.api``.  A decoder LM's bundle:

* ``init(seed, device="cuda", dtype=bf16)`` -> :class:`LMParams`
  (frozen; ``dtype`` is that of the matrices: bf16 to serve, f32 for a
  train state's master weights)
* ``loss(params, batch)``        -> (scalar, {"ce", "aux"})   [train]
* ``prefill(params, batch)``     -> (last logits (B,1,V), dense cache)
* ``decode(params, state)``      -> (logits (B,1,V), new state)
* ``verify(params, tokens, state)`` -> (logits (B,S,V), new state)
* ``prefill_chunk(params, state, tokens, table_row, slot, q_offset)``
  -> (last logits (1,V), state): one chunk of a chunked admission into
  row ``slot`` of a paged or dense decode state (``slot`` and ``q_offset``
  ints, or 0-d int32 device tensors as a captured chunk passes them)

``decode`` runs on a paged state (``init_decode_state(..., kv="paged")``,
with ``block_tables``) or a dense one (``kv="dense"``); ``verify`` on a
paged state; ``prefill_chunk`` on either.  All three update the caches in
place; the JAX reference returns new arrays and its engine donates the old
ones, which is the same memory behaviour.  A VLM's ``loss`` and
``prefill`` prepend the batch's ``frontend`` stub embeddings.

An encoder-decoder's bundle (whisper) has ``init`` ->
:class:`~repro_torch.models.encdec.EncDecParams`, ``loss`` and
``prefill`` of a batch with ``frontend`` frames, and ``decode`` on a dense
state (``init_decode_state(..., kv="dense")``); its ``verify`` and
``prefill_chunk`` are None, as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import COMPUTE


def _text_len(cfg: ArchConfig, seq_len: int) -> int:
    """VLM stubs spend part of the assigned seq budget on patch embeds."""
    if cfg.family == "vlm":
        return seq_len - cfg.frontend_tokens
    return seq_len


def _has_frontend(cfg: ArchConfig) -> bool:
    return cfg.family in ("vlm", "audio")


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
    # None for enc-dec: no speculative verify and no chunked admission
    verify: Callable[[Any, Any, Any], Any] | None = None
    prefill_chunk: Callable[..., Any] | None = None


def default_num_blocks(batch: int, max_len: int, block_size: int) -> int:
    """Pool size matching a dense cache's token capacity, plus the reserved
    scratch block (id 0, the garbage sink for free slots)."""
    return batch * (max_len // block_size) + 1


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      dtype=COMPUTE, kv: str = "paged",
                      num_blocks: int | None = None, block_size: int = 16,
                      device="cuda", mesh=None):
    """Zero decode state: the caches, per-row ``token`` (batch,1) and
    ``pos`` (batch,).  ``kv="paged"``: per-slot block pools plus
    ``block_tables`` (batch, max_len // block_size).  ``kv="dense"``:
    per-slot rings (n_groups, batch, max_len, K, Dh) and no tables.  SSM
    slots hold per-row state in both layouts: ``conv`` (n_groups, batch,
    W-1, conv_dim) bf16 and ``ssd`` (n_groups, batch, H, N, P) f32.  An
    encoder-decoder's state is dense only (`encdec.init_encdec_cache`);
    ``kv="paged"`` raises for it, as in the reference.

    ``mesh`` (a `repro_torch.runtime.mesh.DeviceMesh`) makes the state on
    its ranks by the serve tensor-parallel rules
    (`repro_torch.runtime.sharding.serve_state_shardings`): KV pools and
    rings split on their head or latent dim, each rank's part on its
    device; SSM ``ssd``/``conv`` state, block tables, ``token`` and
    ``pos`` one copy on the lead device (a hybrid's attention pools split,
    its SSM rows not).  This is data row 0's state; the engine makes the
    other data rows' copies (`sharding.state_replicas`).  ``device`` is
    then not read."""
    if kv not in ("paged", "dense"):
        raise ValueError(f"kv must be 'paged' or 'dense', got {kv!r}")
    if cfg.is_encdec and kv == "paged":
        raise ValueError("paged KV is a decoder-LM path; "
                         f"{cfg.name} is enc-dec (use kv='dense')")
    if mesh is not None:
        from repro_torch.runtime.sharding import shard_state
        return shard_state(init_decode_state(
            cfg, batch, max_len, dtype=dtype, kv=kv, num_blocks=num_blocks,
            block_size=block_size, device="meta"), mesh)
    dev = resolve_device(device)
    state = {"token": torch.zeros((batch, 1), dtype=torch.int32, device=dev),
             "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.is_encdec:
        return {"cache": encdec_mod.init_encdec_cache(cfg, batch, max_len,
                                                      dtype, dev), **state}
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
    if cfg.is_encdec:
        return _build_encdec(cfg, compute)
    return _build_lm(cfg, compute)


def _seeded(device, seed: int):
    """The device and a generator seeded on it.  On the meta device (shape
    stand-ins, `repro_torch.launch.specs`) there are no numbers to draw and
    no generator: the init functions then allocate nothing."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return dev, None
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return dev, gen


def _build_lm(cfg, compute):
    def init(seed: int = 0, *, device="cuda", dtype=compute):
        dev, gen = _seeded(device, seed)
        return tf.init_lm_params(cfg, gen, dev, dtype)

    def loss(params, batch):
        return tf.lm_loss(params, cfg, batch["tokens"], batch["targets"],
                          extra_embeds=batch.get("frontend"), compute=compute)

    def prefill(params, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape
        S += cfg.frontend_tokens if _has_frontend(cfg) else 0
        cache = tf.init_cache(cfg, B, S, dtype=compute, device=tokens.device)
        return tf.lm_prefill(params, cfg, tokens, cache,
                             extra_embeds=batch.get("frontend"),
                             compute=compute)

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


def _build_encdec(cfg, compute):
    def init(seed: int = 0, *, device="cuda", dtype=compute):
        dev, gen = _seeded(device, seed)
        return encdec_mod.init_encdec_params(cfg, gen, dev, dtype)

    def loss(params, batch):
        return encdec_mod.encdec_loss(params, cfg, batch["frontend"],
                                      batch["tokens"], batch["targets"],
                                      compute=compute)

    def prefill(params, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache = encdec_mod.init_encdec_cache(cfg, B, S, dtype=compute,
                                             device=tokens.device)
        return encdec_mod.encdec_prefill(params, cfg, batch["frontend"],
                                         tokens, cache, compute=compute)

    def decode(params, state):
        logits, cache = encdec_mod.encdec_decode(
            params, cfg, state["token"], state["cache"], state["pos"],
            compute=compute)
        token = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return logits, {**state, "cache": cache, "token": token,
                        "pos": state["pos"] + 1}

    return ModelBundle(cfg, init, loss, prefill, decode)
