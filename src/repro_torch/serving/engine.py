"""Batched serving engine: continuous batching over a paged (or dense) KV
cache, with optional draft-and-verify speculative decoding.

Port of ``repro.serving.engine``.  With ``kv="paged"`` (the default) the
engine owns one
block pool per attention slot — ``(n_groups, num_blocks, block_size,
heads, dh)``, or MLA's latent pools ``(..., kv_lora_rank)`` and ``(...,
qk_rope_head_dim)`` — plus a per-slot block table ``(slots, max_len //
block_size)`` mapping logical position ``p`` of slot ``s`` to
``pool[table[s, p // bs], p % bs]``.  A host-side
:class:`~repro_torch.serving.blockpool.BlockAllocator` hands out physical
blocks at admission granularity (the request's whole reach: prompt bucket
plus token budget, capped at ``max_len``), and eviction returns them all;
the decode loop never touches the table.  ``kv="dense"`` keeps a
``(slots, max_len)`` ring per slot instead: the ablation, bitwise equal to
paged decode (same shapes, same masks, same reduction order).  An
attention-free arch (Mamba-2) has nothing to page: it serves on the dense
layout, whose SSM slots hold per-row ``{conv, ssd}`` state that admission
writes whole.  So does a sliding-window arch (mixtral), whose rings hold
``min(max_len, window)`` positions a row, written at ``pos mod window``
(always fully live, nothing to page); it has no prefix cache and no
speculation (a ring overwrites history in place).  A hybrid (jamba) pages
its attention slots and keeps per-row state in its SSM slots, with no
prefix cache and no speculation; a VLM (llava) serves text only, as the
reference's engine does; an encoder-decoder (whisper) is refused at
construction: its prefill needs frames, and it runs through its bundle.

* **prefix reuse** (paged) — admission hashes the padded prompt per full
  block (chain hash, so a hit guarantees bit-identical KV); matching
  leading blocks are mapped into the slot's table copy-free with a
  refcount bump.  One-shot admission still recomputes the whole prefill
  and skips the shared blocks' scatter.
* **per-slot positions** — after admission into slot ``s`` with bucket
  ``plen``, ``pos[s] == plen`` and rows ``0..plen-1`` hold the left-padded
  prompt KV; each decode step writes row ``s`` at ``pos[s]`` and advances
  it, so admitting a request mid-decode leaves the other slots' streams
  bitwise identical to a solo run.  Free slots keep stepping over the
  scratch block 0 (paged) or their own row (dense).
* **speculative decoding** (``spec="draft"``, paged only) — each step runs
  ``spec_k`` draft decodes into shadow pools addressed by the target's
  block ids, then one ``spec_k + 1``-query verify forward of the target;
  greedy acceptance commits exactly the tokens of ``spec="off"``.  A
  rejected suffix is rolled back by not advancing the frontier.
* **chunked prefill** (``prefill="chunked"``) — admission claims the slot
  and its blocks, then ``_prefill_tick`` runs at most one
  ``prefill_chunk``-token chunk a tick (`ModelBundle.prefill_chunk`, into
  the admitted row only) before the tick's decode step, so running slots
  keep their pace while a long prompt arrives.  Chunk boundaries sit at
  absolute multiples of the chunk, which keeps the chunk shapes a small
  static set (`prefill_chunk_shapes`).  The decode step advances every
  row's per-row state (dense rings, SSM rows), so a mid-admission row's
  state is saved before it and written back after (`_guard_rows`).
* **one transfer per step** — the step is device-resident and returns one
  packed int32 tensor (``(2, slots)`` tokens and done flags, or ``(k+3,
  slots)`` accepted lengths, done flags and verified tokens); its one
  ``.cpu()`` copy is the only device->host transfer of a step
  (``d2h_transfers == steps``).  Table maintenance is host->device only.

The JAX engine jits the step and donates the decode state.  Here the step
writes everything in place: the caches (``index_put_``) and the engine's
own ``token``, ``pos``, ``active`` and ``budget`` (``copy_``), which the
engine never rebinds.  On a CUDA device the engine replays CUDA graphs
(`repro_torch.serving.graph`) where the reference calls a jitted function:
the decode step, and the draft chain and the verify step of a
``spec="draft"`` engine, each captured once while every slot is free; the
one-shot admission prefill (target and draft) once per admit bucket, and
the chunk function once per chunk shape, each captured at its first use
(that call runs eagerly and is the capture's warm-up, as a jit compiles on
its first call) or ahead of traffic by `ServeEngine.warm_admission`.  The
admission graphs share one memory pool, and the one-shot ones of each
model one output (`repro_torch.serving.graph.SharedOutput`: each replay's
outputs are read before another of them replays), so their captures hold
one admission's working set and one prefill cache, the largest bucket's;
the decode step and the spec pair keep pools of their own.  ``step_graph=False`` keeps every one of them eager (the
comparison), and the CPU always runs eagerly.  As the reference's does,
the engine takes its step, prefill,
chunk, draft, verify and draft-prefill functions from the caller
(``step_fn`` ... ``draft_prefill_fn``; None builds its own), so the
engines of one serve image share them; the graph captures whichever step
it was given.  Construction, each step, the admission warm-up and a cancel
hold `repro_torch.serving.graph.DEVICE_LOCK` (the device work of a
prefetch on another thread waits for them, and they for it), and the
engine counts the kernel launches it made under it (``launches`` in its
stats).

* **tensor parallelism** (``mesh``, a
  `repro_torch.runtime.mesh.DeviceMesh`) — the params are placed at
  construction by the serve rules (`repro_torch.runtime.sharding`: column
  leaves split over the model ranks, the rest one copy on the lead
  device) and so are the pools (split on their head or latent dim); each
  layer loops over the ranks, and the kernels run once a rank at its
  head count.  The block allocator, the prefix cache, the block tables,
  ``token``, ``pos``, ``active`` and ``budget`` stay one, on the lead
  device, so the packed transfer stays one ``.cpu()`` a step.  Streams
  are bitwise the single-device engine's (each product that contracts a
  split dim runs whole after a gather).  With every rank on one device
  the ``spec="off"`` step is captured as one graph, as without a mesh;
  across devices it runs eagerly.  Every decoder family the engine
  serves runs under a mesh (GQA, MLA, MoE, SSM and hybrid stacks), in
  every role, with one-shot, chunked and wave admission, both layouts and
  speculation: an MoE FFN runs its router and dispatch on the lead device
  and ``up``/``gate`` on each rank's columns; SSM mixers and their state
  are replicated by the rules, so they run once on the lead device.  A
  split role's handoff carries the one-device wire layout (each rank's
  blocks concatenated on its pool's split dim), so mesh and one-device
  engines take each other's handoffs.  A data axis above 1 is the
  reference's replication: each further data row holds a copy of the
  params and the state, the rank loop runs on row 0, and an MoE decode
  step computes each row's slice of the experts on that row.
  Prefix-shared blocks need no copy-on-write (only full prompt blocks
  are shared, and decode never writes below its frontier), so there is
  nothing to copy in any rank's pool.

* **disaggregated roles** (``role="prefill"`` / ``"decode"``, paged only)
  — a prefill-role engine admits, exports the slot's prompt blocks as a
  :class:`~repro_torch.serving.blockpool.KVHandoff` and frees the slot at
  once; it has no step function and captures no graph.  A decode-role
  engine admits only handoffs: it scatters their blocks into its own pool
  IN PLACE (the captured step replays fixed addresses) and resumes at the
  handoff's first token, bitwise as a unified engine would.  The export
  gathers every layer's blocks into one device buffer and pulls it to the
  host once; a bf16 pool travels as its raw 16-bit pattern (int16).
* **wave admission** (``admission="wave"``, the baseline) — free slots
  refill only once every slot is free.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.models import moe
from repro_torch.models.api import (
    build_model, default_num_blocks, init_decode_state, resolve_device)
from repro_torch.runtime.sharding import (
    Shards, pairs, parts, rank_bytes, shard_params, state_replicas)
from repro_torch.serving.blockpool import (
    BlockAllocator, KVHandoff, PrefixCache)
from repro_torch.serving.graph import (
    DEVICE_LOCK, CallGraph, SharedOutput, StepGraph, launch_counts,
    pool_bytes)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    submitted: float = dataclasses.field(default_factory=time.monotonic)
    # filled on completion
    tokens: list = dataclasses.field(default_factory=list)
    first_token_s: float | None = None
    done_s: float | None = None
    # disaggregated serving: a prefill-role engine fills this on export;
    # a decode-role engine resumes from it instead of a raw prompt
    handoff: KVHandoff | None = None


@dataclasses.dataclass
class SlotState:
    rid: int = -1                      # -1 == free
    active: bool = False               # decoding (False mid-admission)


@dataclasses.dataclass
class _PrefillJob:
    """A chunked admission in flight: the slot is claimed, the blocks are
    mapped, ``off`` is the next chunk's absolute start position."""
    si: int
    req: Request
    padded: np.ndarray                 # (plen,) int32 left-padded prompt
    plen: int
    off: int                           # == prefix-hit tokens at creation
    row: list                          # physical block ids (prefix + fresh)
    keys: list                         # full-block chain-hash keys
    nhit: int = 0                      # prefix-hit blocks (draft install)


def admit_length(prompt_len: int, max_len: int) -> int:
    """Round a prompt length up to its power-of-two bucket (at least 16),
    capped at ``max_len - 1`` so decode has at least one KV row.  Raises
    ValueError for a prompt that cannot fit instead of cropping it."""
    if prompt_len >= max_len:
        raise ValueError(
            f"prompt length {prompt_len} exceeds the admission cap "
            f"{max_len - 1} (= max_len {max_len} minus the >=1 KV row "
            f"decode needs); truncate the prompt to <= {max_len - 1} "
            f"tokens or build the engine with a larger max_len")
    b = 16
    while b < prompt_len:
        b *= 2
    return min(b, max_len - 1)


def admit_buckets(max_len: int) -> list[int]:
    """Every prompt bucket `admit_length` can produce for ``max_len``."""
    out = []
    b = 16
    while b < max_len - 1:
        out.append(b)
        b *= 2
    out.append(max_len - 1)
    return out


def prefill_chunk_shapes(max_len: int, block_size: int,
                         chunk: int) -> list[int]:
    """Every chunk length chunked admission can produce: chunk boundaries
    sit at absolute multiples of ``chunk`` and a prefix hit can start a job
    at any block boundary, so the set is {min(chunk - off % chunk, plen -
    off)} over every bucket and block-aligned offset.  Small and static:
    warmable ahead of the first request."""
    shapes = set()
    for plen in admit_buckets(max_len):
        for off in range(0, plen, block_size):
            shapes.add(min(chunk - off % chunk, plen - off))
    return sorted(shapes)


def make_engine_step(bundle, max_len: int):
    """The engine's decode step: decode + argmax + per-slot budget debit +
    done mask, all on the device.  It writes the new ``token`` and ``pos``
    into ``state`` and the new ``active`` and ``budget`` into the tensors
    it was given, IN PLACE (the caches are written in place by the decode
    itself), and returns one packed (2, slots) int32 tensor.  Nothing in it
    reads a value back to the host, so it can be captured as a graph."""

    def step(params, state, active, budget):
        _, new_state = bundle.decode(params, state)          # argmax inside
        tok = new_state["token"][:, 0]
        new_budget = budget - active.to(torch.int32)
        done = active & ((new_budget <= 0) | (new_state["pos"] >= max_len))
        packed = torch.stack([tok, done.to(torch.int32)])    # (2, slots)
        state["token"].copy_(new_state["token"])
        state["pos"].copy_(new_state["pos"])
        active.copy_(active & ~done)
        budget.copy_(new_budget)
        return packed

    return step


def make_draft_step(bundle, k: int, max_len: int):
    """The draft half of a speculative step: ``k`` autoregressive draft
    decodes (a Python loop; nothing is read back to the host).  The draft
    writes its KV into its OWN paged pools, addressed by the TARGET's block
    tables — same physical block ids, so admission/eviction bookkeeping
    covers both caches.  Returns ``(drafts (slots, k) int32, draft
    cache)``."""

    def draft(params, cache, token, pos, block_tables):
        state = {"cache": cache, "token": token, "pos": pos,
                 "block_tables": block_tables}
        toks = []
        for _ in range(k):
            # clamp the write position: a row whose speculative reach
            # crosses max_len keeps overwriting its last in-bounds
            # position, a block only this row owns (prefix sharing never
            # reaches the final position's block); drafts past the end are
            # never accepted (acceptance clamps at max_len - pos)
            _, nst = bundle.decode(
                params, {**state, "pos": torch.clamp(state["pos"],
                                                     max=max_len - 1)})
            state = {**nst, "pos": state["pos"] + 1}
            toks.append(nst["token"][:, 0])
        return torch.stack(toks, dim=1), state["cache"]

    return draft


def make_verify_step(bundle, max_len: int, k: int):
    """The verify half of a speculative step: ONE batched (k+1)-position
    target forward over [pending token, k drafts], then greedy acceptance
    (truncate at the first draft/target mismatch), budget debit and done
    mask, all on the device, written in place as `make_engine_step` writes
    them.  The packed return is one (k+3, slots) int32 tensor: row 0 the
    accepted length ``a`` (0 for free slots), row 1 the done flags, rows
    2..k+2 the k+1 target-verified tokens (the host appends the first
    ``a``).  A rejected suffix needs no device work to
    roll back: the frontier does not advance over it, the next step's
    writes land at the committed frontier and overwrite it, and each
    query's causal mask hides anything past its own position."""

    def step(params, state, active, budget, drafts):
        tokens = torch.cat([state["token"], drafts], dim=1)
        logits, _ = bundle.verify(params, tokens, state)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)   # (B, k+1)
        # t_{s+1} is valid iff its input d_s matched the target's own pick
        # t_s at every position up to s: cumprod of the match mask
        match = (preds[:, :k] == drafts).to(torch.int32)
        a = 1 + torch.cumprod(match, dim=1, dtype=torch.int32).sum(
            dim=1, dtype=torch.int32)
        # clamp to the slot's budget and max_len room (verify probes up to
        # k positions past both; the overshoot is never committed), zero
        # for free slots
        a = torch.minimum(a, torch.minimum(budget, max_len - state["pos"]))
        a = torch.clamp(a, min=0) * active.to(torch.int32)
        new_budget = budget - a
        pos = state["pos"] + a
        done = active & ((new_budget <= 0) | (pos >= max_len))
        token = torch.gather(preds, 1, torch.clamp(a - 1, min=0)[:, None]
                             .long())
        token = torch.where(active[:, None], token, state["token"])
        packed = torch.cat([a[None], done.to(torch.int32)[None], preds.T])
        state["token"].copy_(token)
        state["pos"].copy_(pos)
        active.copy_(active & ~done)
        budget.copy_(new_budget)
        return packed

    return step


def spec_ineligible_reason(cfg, kv: str) -> str | None:
    """Why an arch cannot run draft-and-verify speculation (None == it
    can).  Instead of failing, the engine records the reason and serves
    non-speculatively."""
    if cfg.is_encdec:
        return "enc-dec archs have no decoder-only verify path"
    if cfg.is_attention_free or cfg.ssm is not None:
        return ("SSM state rows advance one token at a time and cannot "
                "roll back a rejected speculative suffix")
    if cfg.sliding_window is not None:
        return ("SWA rolling rings overwrite history in place and cannot "
                "roll back a rejected speculative suffix")
    if kv != "paged":
        return ("speculative rollback rides the paged block tables; "
                "kv='dense' has no frontier to truncate")
    return None


def handoff_ineligible_reason(cfg, kv: str) -> str | None:
    """Why an arch cannot serve in a disaggregated role (None == it can).
    The KV handoff moves PAGED BLOCKS between pools, so every per-token
    byte a decode step reads must live inside blocks: per-row state (SSM
    scan rows, SWA rolling rings) has no block id to ship."""
    if cfg.is_encdec:
        return "enc-dec archs do not run the decoder-only serve path"
    if cfg.is_attention_free or cfg.ssm is not None:
        return ("SSM state rows are per-slot, not per-block; they cannot "
                "ride a block-chain handoff")
    if cfg.sliding_window is not None:
        return ("SWA ring rows are per-slot, not per-block; they cannot "
                "ride a block-chain handoff")
    if kv != "paged":
        return "the handoff ships paged blocks; kv='dense' has none"
    return None


# each paged pool's key -> the key of the one-shot prefill's leaf it takes
_PAGED_KEYS = {"kp": "k", "vp": "v", "ckvp": "ckv", "kropep": "krope"}
# the dense per-row leaves that are rings of positions (K/V, MLA's latent)
_RING_KEYS = ("k", "v", "ckv", "krope")
# the kinds of admission graph an engine captures at first use
_ADMIT_GRAPHS = ("prefill", "draft_prefill", "chunk")


def _on_device(method):
    """Run an engine method under `DEVICE_LOCK` and add the kernel launches
    it made to the engine's own count, ``launches`` (a graph's warm-up
    steps at construction are launches; its capture is none)."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        with DEVICE_LOCK:
            before = launch_counts()
            try:
                return method(self, *args, **kw)
            finally:                 # (__init__ runs before launches exists)
                mine = self.__dict__.setdefault("launches", {})
                for name, n in launch_counts().items():
                    if n != before[name]:
                        mine[name] = mine.get(name, 0) + n - before[name]
    return run


class ServeEngine:
    """Continuous-batching engine on ``device`` ("cuda" by default; a
    missing card raises).  ``params`` is the port's :class:`LMParams` on
    that device.

    * ``kv`` — "paged" (default for decoder LMs) or "dense" (the ablation;
      the only layout of an attention-free arch, whatever ``kv`` asks).
    * ``spec`` — "off" or "draft": ``spec_k`` draft tokens per step from
      ``draft_cfg`` (None: the target drafts for itself) with
      ``draft_params`` (None: ``build_model(draft_cfg).init(0)``), verified
      by one target forward.  An arch or layout that cannot roll back a
      rejected suffix serves with ``spec="off"`` and records why in
      ``spec_fallback_reason``.
    * ``prefill`` — "oneshot" (the whole bucket at admission) or "chunked"
      (``prefill_chunk``-token chunks, at most one a tick, interleaved with
      decode; a multiple of ``block_size`` on the paged layout; a dense MLA
      engine admits one-shot, as the reference's).
    * ``step_graph`` — the one switch over every function the reference
      compiles (the decode step, the draft chain and verify step, the
      admission prefill of each bucket, target and draft, and the chunk
      function of each chunk shape).  None: CUDA graphs on a CUDA device
      when every rank of the mesh is on it, eager otherwise; False: all
      eager; True: the graphs, raising where there can be none (the CPU,
      a mesh across devices).  A capture that fails raises.
    * ``role`` — "unified", or a disaggregated "prefill" (admits and
      exports handoffs; no step function) or "decode" (imports handoffs;
      no prefill or chunk function, one-shot); a split role forces
      ``spec="off"`` and records why.
    * ``admission`` — "continuous" (refill any free slot) or "wave" (the
      baseline: refill once every slot is free).
    * ``step_fn``, ``prefill_fn``, ``chunk_fn``, ``draft_fn``,
      ``verify_fn``, ``draft_prefill_fn`` — the functions a serve image's
      factory shares among its engines (`make_engine_step`,
      ``bundle.prefill``, ``bundle.prefill_chunk``, `make_draft_step`,
      `make_verify_step`, the draft bundle's prefill); None builds the
      engine's own.
    * ``mesh`` — None (one device), or a
      `repro_torch.runtime.mesh.DeviceMesh` whose lead device is
      ``device``: params and pools are placed on its ranks."""

    @_on_device
    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 kv: str | None = None, block_size: int = 16,
                 num_blocks: int | None = None, prefill: str = "oneshot",
                 prefill_chunk: int = 32, prefix_sharing: bool = True,
                 bundle=None, step_fn=None, prefill_fn=None, chunk_fn=None,
                 spec: str = "off", spec_k: int = 4, draft_cfg=None,
                 draft_params=None, draft_bundle=None, draft_fn=None,
                 verify_fn=None, draft_prefill_fn=None, mesh=None,
                 role: str = "unified", admission: str = "continuous",
                 device="cuda", step_graph: bool | None = None):
        if prefill not in ("oneshot", "chunked"):
            raise ValueError(
                f"prefill must be 'oneshot' or 'chunked', got {prefill!r}")
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"role must be 'unified', 'prefill' or "
                             f"'decode', got {role!r}")
        if admission not in ("continuous", "wave"):
            raise ValueError(f"admission must be 'continuous' or 'wave', "
                             f"got {admission!r}")
        # an arch pages only if some attention layer's per-token state can
        # live in blocks (all-SWA rings and pure SSM state cannot)
        pages = (not cfg.is_attention_free
                 and (cfg.mla is not None or cfg.sliding_window is None))
        if kv is None or (kv == "paged" and not pages):
            kv = "paged" if pages else "dense"
        if kv not in ("paged", "dense"):
            raise ValueError(f"kv must be 'paged' or 'dense', got {kv!r}")
        if role != "unified":
            reason = handoff_ineligible_reason(cfg, kv)
            if reason is not None:
                raise ValueError(
                    f"role={role!r} needs the KV block handoff: {reason}")
        if cfg.is_encdec:
            raise ValueError(
                f"{cfg.name}: enc-dec archs do not run the decoder-only serve "
                "path; their prefill needs frames (run the bundle's prefill "
                "and decode, or the prefill and decode images)")
        if spec not in ("off", "draft"):
            raise ValueError(f"spec must be 'off' or 'draft', got {spec!r}")
        self.device = resolve_device(device)
        if params.embed.device != self.device:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"engine on {self.device}")
        # tensor-parallel serving: params by the serve TP rules, KV pools
        # on their head or latent dim, everything else one copy on the
        # lead device; every step runs the rank loop over the mesh
        self.mesh = mesh
        self.mesh_devices = 1
        if mesh is not None:
            # the block tables, the replicated leaves and the gathers
            # live on the lead device
            if mesh.lead != self.device:
                raise ValueError(f"the mesh's lead device is {mesh.lead}, "
                                 f"the engine's {self.device}")
            self.mesh_devices = int(mesh.devices.size)
            # every row count a column product of this engine takes: the
            # decode rows (the step's, the verify burst's and the chunks':
            # the MoE decode product's, whose experts a data axis splits),
            # the heads' and the logits' at admission (the bucket, and 1)
            # and an MoE FFN's capacity at each bucket
            decode = {slots, slots * (int(spec_k) + 1)}
            if prefill == "chunked":
                decode |= set(prefill_chunk_shapes(max_len, block_size,
                                                   int(prefill_chunk)))
            rows = {1, *decode, *admit_buckets(max_len)}
            if cfg.moe is not None:
                rows |= {moe._capacity(cfg, b)
                         for b in admit_buckets(max_len)}
            self._gemm_rows = sorted(rows)
            self._decode_rows = sorted(decode)
            params = shard_params(params, mesh, rows=self._gemm_rows,
                                  decode_rows=self._decode_rows)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.kv = kv
        self.role = role
        self.admission = admission
        self.block_size = block_size
        self.bundle = bundle or build_model(cfg)
        # chunked admission runs on both layouts except dense MLA, whose
        # chunk path speaks only the paged latent pools (the reference's
        # gate): it admits one-shot
        self.prefill_mode = ("oneshot" if kv == "dense"
                             and cfg.mla is not None else prefill)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk <= 0 or (kv == "paged"
                                       and self.prefill_chunk % block_size):
            raise ValueError(
                f"prefill_chunk must be a positive multiple of block_size "
                f"{block_size} on the paged layout, got {prefill_chunk}")
        if kv == "paged":
            nb = num_blocks or default_num_blocks(slots, max_len, block_size)
            self._num_blocks = nb
            self.allocator = BlockAllocator(nb, block_size)
            # per-row state (SWA rings, SSM rows) rides no block chain, so a
            # prefix hit could not restore it (the reference's gate)
            prefix_ok = (prefix_sharing and cfg.sliding_window is None
                         and cfg.ssm is None)
            self.prefix = PrefixCache(self.allocator) if prefix_ok else None
            self.state = init_decode_state(cfg, slots, max_len, kv="paged",
                                           num_blocks=nb,
                                           block_size=block_size,
                                           device=self.device, mesh=mesh)
            self.max_blocks_per_slot = max_len // block_size
        else:
            self._num_blocks = 0
            self.allocator = None
            self.prefix = None
            self.state = init_decode_state(cfg, slots, max_len, kv="dense",
                                           device=self.device, mesh=mesh)
            self.max_blocks_per_slot = 0
        # a data axis above 1: every further data row holds a copy of the
        # state's placement, as the reference replicates it (the rank loop
        # runs on row 0)
        self.state_replicas = ([] if mesh is None
                               else state_replicas(self.state, mesh))
        self.budget = torch.zeros((slots,), dtype=torch.int32,
                                  device=self.device)
        self.active = torch.zeros((slots,), dtype=torch.bool,
                                  device=self.device)
        self.slot_meta = [SlotState() for _ in range(slots)]
        self.queue: deque[Request] = deque()
        self._jobs: deque[_PrefillJob] = deque()
        self.done: dict[int, Request] = {}
        self._live: dict[int, Request] = {}
        self._host_pos = [0] * slots
        self._slot_blocks: list[list[int]] = [[] for _ in range(slots)]
        self._tick_times: list[float] = []
        self.last_step_ns = (0, 0)           # the last `step`'s two stamps
        # the disaggregated roles' handoffs: each export's and import's
        # host milliseconds and each export's wire bytes
        self.prefills_exported = 0
        self.handoffs_imported = 0
        self._export_ms: list[float] = []
        self._import_ms: list[float] = []
        self._handoff_bytes: list[int] = []
        self.steps = 0
        self.idle_slot_steps = 0
        self.d2h_transfers = 0         # must equal `steps` (one per step)
        self.prefill_chunks = 0
        self.blocked_admissions = 0
        self.prompt_tokens_total = 0
        self.prefix_hit_tokens = 0
        self._kv_util_sum = 0.0
        self.kv_peak_live_tokens = 0
        self.tokens_emitted = 0        # committed tokens (all modes)
        # speculative-decode accounting (all zero when spec == "off")
        self.spec_drafted = 0          # draft proposals scored by verify
        self.spec_accepted = 0         # of those, committed to requests
        self.draft_time_s = 0.0        # time inside the draft chain
        self._draft_events = None      # CUDA events around this step's chain
        # a prefill-role engine never decodes (its slots turn over at the
        # export) and a decode-role engine never prefills (its admissions
        # scatter imported blocks), so each drops the other half
        self._step_fn = (None if role == "prefill"
                         else step_fn or make_engine_step(self.bundle,
                                                          max_len))
        self._prefill = (None if role == "decode"
                         else prefill_fn or self.bundle.prefill)
        self._chunk_fn = (None if role == "decode"
                          else chunk_fn or self.bundle.prefill_chunk)
        if role == "decode":
            self.prefill_mode = "oneshot"    # no chunk path to interleave

        # ---- speculative decoding: draft-and-verify multi-token steps ----
        self.spec = "off"
        self.spec_k = int(spec_k)
        self.spec_fallback_reason = None
        if spec == "draft" and role != "unified":
            # the draft's shadow pools do not ride the handoff, so a
            # resumed request would draft over garbage KV
            self.spec_fallback_reason = (
                f"role={role}: draft KV does not ride the block handoff")
            spec = "off"
        if spec == "draft":
            reason = spec_ineligible_reason(cfg, self.kv)
            if reason is None and draft_cfg is not None:
                dr = spec_ineligible_reason(draft_cfg, "paged")
                if dr is not None:
                    reason = f"draft arch: {dr}"
                elif draft_cfg.vocab_size != cfg.vocab_size:
                    reason = ("draft vocab differs from target "
                              f"({draft_cfg.vocab_size} vs "
                              f"{cfg.vocab_size}); proposals would not be "
                              "target token ids")
            if reason is not None:
                self.spec_fallback_reason = reason
            else:
                self.spec = "draft"
        if self.spec == "draft":
            # draft_cfg None == self-draft: the target proposes for itself
            # (the upper-bound ablation; every proposal is accepted)
            self.draft_cfg = draft_cfg or cfg
            self.draft_bundle = draft_bundle or (
                self.bundle if draft_cfg is None
                else build_model(self.draft_cfg))
            if draft_params is not None:
                self.draft_params = draft_params
            elif draft_cfg is None:
                self.draft_params = self.params
            else:
                # a fixed seed: every engine builds the same draft weights
                self.draft_params = self.draft_bundle.init(
                    0, device=self.device)
            if self.draft_params.embed.device != self.device:
                raise ValueError(f"draft params live on "
                                 f"{self.draft_params.embed.device}, the "
                                 f"engine on {self.device}")
            if mesh is not None and self.draft_params is not self.params:
                self.draft_params = shard_params(
                    self.draft_params, mesh, rows=self._gemm_rows,
                    decode_rows=self._decode_rows)
            # the draft's pools shadow the target's: same num_blocks and
            # block_size, addressed through the SAME block-table ids, so
            # admission/eviction bookkeeping covers both caches at once
            self._draft_cache = init_decode_state(
                self.draft_cfg, slots, max_len, kv="paged",
                num_blocks=self._num_blocks, block_size=block_size,
                device=self.device, mesh=mesh)["cache"]
            self._draft_fn = draft_fn or make_draft_step(
                self.draft_bundle, self.spec_k, max_len)
            self._verify_fn = verify_fn or make_verify_step(
                self.bundle, max_len, self.spec_k)
            self._draft_prefill = (draft_prefill_fn
                                   or self.draft_bundle.prefill)

        # ---- the reference's jit boundaries as captured CUDA graphs ----
        # (under a mesh only when every rank is on one device: across
        # devices everything runs eager)
        one_device = mesh is None or len(set(mesh.devices.flat)) == 1
        if step_graph is None:
            step_graph = self.device.type == "cuda" and one_device
        if step_graph and not one_device:
            raise ValueError("step_graph=True needs every rank of the mesh "
                             "on one device; across devices the engine "
                             "runs eagerly")
        if step_graph and self.device.type != "cuda":
            raise ValueError("step_graph=True needs a CUDA device; the CPU "
                             "runs eagerly")
        self.step_graph = bool(step_graph)
        # the admission graphs of each kind, keyed by bucket (target,
        # draft) and by chunk length, captured at first use into one
        # shared pool; the one-shot ones of each model share one output
        self._admit_pool = (torch.cuda.graph_pool_handle() if step_graph
                            else None)
        self._admit_out = {k: SharedOutput()
                           for k in ("prefill", "draft_prefill")}
        self._admit_graphs: dict[str, dict[int, CallGraph]] = {
            k: {} for k in _ADMIT_GRAPHS}
        # every key each kind ran as a graph (a dropped graph's too)
        self._admit_ran: dict[str, set[int]] = {k: set()
                                                for k in _ADMIT_GRAPHS}
        decodes = step_graph and role != "prefill"
        self._graph = (self._capture_step()
                       if decodes and self.spec == "off" else None)
        self._spec_graphs = (self._capture_spec()
                             if decodes and self.spec == "draft" else None)

    def _capture_step(self) -> StepGraph:
        """Capture the decode step while every slot is free.  The warm-up
        runs write only what a free slot's step always writes (the scratch
        block, free rows), then ``token``, ``pos``, ``active`` and
        ``budget`` are zeroed again.  The closure holds the engine's
        tensors, not the engine."""
        step, params, state = self._step_fn, self.params, self.state
        active, budget = self.active, self.budget

        def reset():
            for t in (state["token"], state["pos"], active, budget):
                t.zero_()

        return StepGraph(lambda: step(params, state, active, budget),
                         self.device, reset, kind="decode")

    def _capture_spec(self) -> tuple[StepGraph, StepGraph]:
        """Capture the draft chain and the verify step, in that order,
        while every slot is free (`_capture_step`'s reasoning: free slots
        write only the scratch block).  The draft graph's static output,
        the drafts, is the verify graph's input; it is zeroed before the
        verify warm-up reads it (a capture computes nothing)."""
        draft, verify = self._draft_fn, self._verify_fn
        dparams, dcache = self.draft_params, self._draft_cache
        params, state = self.params, self.state
        active, budget = self.active, self.budget

        def reset():
            for t in (state["token"], state["pos"], active, budget):
                t.zero_()

        dg = StepGraph(lambda: draft(dparams, dcache, state["token"],
                                     state["pos"], state["block_tables"])[0],
                       self.device, reset, kind="draft")
        drafts = dg.out
        drafts.zero_()
        vg = StepGraph(lambda: verify(params, state, active, budget, drafts),
                       self.device, reset, kind="verify")
        return dg, vg

    def _graphs(self) -> list:
        """Every graph the engine holds (each a `StepGraph`)."""
        out = [self._graph] if self._graph is not None else []
        out += list(self._spec_graphs or ())
        for graphs in self._admit_graphs.values():
            out += [g.step for g in graphs.values()]
        return out

    def graph_bytes(self) -> int:
        """The device memory the engine's captures hold: their pools'
        segments (their shared outputs included)."""
        return pool_bytes(self._graphs())

    def _graphed(self, kind: str, key: int, fn, args):
        """``fn(*args)`` as the replay of the ``kind`` graph of ``key``
        (an admission bucket or chunk length), captured into the admission
        pool by this call when it has none yet (this call then runs eagerly
        as its warm-up).  A capture whose output became its kind's shared
        one (`SharedOutput`) drops the graphs that write into the old one:
        each is captured again at its next use."""
        graphs = self._admit_graphs[kind]
        self._admit_ran[kind].add(key)
        g = graphs.get(key)
        if g is not None:
            return g(*args)
        shared = self._admit_out.get(kind)
        gen = shared.generation if shared is not None else 0
        g, out = CallGraph.first_call(fn, args, self.device,
                                      pool=self._admit_pool, kind=kind,
                                      key=key)
        if shared is not None and shared.generation != gen:
            graphs.clear()
        graphs[key] = g
        return out

    def _run_prefill(self, kind: str, fn, params, tokens):
        """The one-shot admission prefill of ``tokens`` (1, bucket):
        ``(logits, prefill cache)``.  On a graphed engine it is the replay
        of the ``kind`` ("prefill" or "draft_prefill") graph of its bucket,
        its output a view of the kind's shared one, read before the next
        admission graph replays.  The closure holds the function, the
        params and the shared output, not the engine."""
        if self._admit_pool is None:
            return fn(params, {"tokens": tokens})
        shared = self._admit_out[kind]
        return self._graphed(
            kind, tokens.shape[1],
            lambda t: shared.place(fn(params, {"tokens": t})), (tokens,))

    def _run_chunk(self, toks, row_t, si: int, off: int):
        """One chunk's last-position logits (1, V): the chunk function with
        ``slot`` and ``q_offset`` as ints, or on a graphed engine the
        replay of the chunk length's graph, whose tokens, table row, slot
        and offset (0-d int32, the reference's traced scalars) are static
        buffers copied in before it."""
        if self._admit_pool is None:
            return self._chunk_fn(self.params, self.state, toks, row_t, si,
                                  off)[0]
        chunk, params, state = self._chunk_fn, self.params, self.state
        scalars = (torch.tensor(si, dtype=torch.int32),
                   torch.tensor(off, dtype=torch.int32))
        return self._graphed(
            "chunk", toks.shape[1],
            lambda t, r, s, o: chunk(params, state, t, r, s, o)[0],
            (toks, row_t, *scalars))

    # ------------------------------------------------------------------

    @property
    def kv_capacity_tokens(self) -> int:
        if self.kv == "paged":
            return self.allocator.capacity_tokens
        return self.slots * self.max_len

    def submit(self, req: Request):
        """Queue a request.  A prompt that cannot fit the KV budget (prompt
        + one generated token within ``max_len``, and a worst-case block
        reach within the pool) is rejected here, explicitly."""
        if req.rid == -1:
            raise ValueError("request id -1 is reserved (the engine's "
                             "free-slot sentinel)")
        if req.handoff is not None:
            if self.role != "decode":
                raise ValueError(
                    f"role={self.role!r} engine cannot import a KV handoff "
                    "(only role='decode' resumes from one)")
            req.handoff.validate_against(self.kv_fingerprint())
            plen = req.handoff.plen
            if plen >= self.max_len:
                raise ValueError(
                    f"handoff bucket {plen} leaves no decode room inside "
                    f"max_len {self.max_len}")
            end_max = min(plen + req.max_new_tokens, self.max_len)
            need = -(-end_max // self.block_size)
            if need > self.allocator.capacity_blocks:
                raise ValueError(
                    f"handoff needs {need} KV blocks (bucket {plen} + "
                    f"budget {req.max_new_tokens}) but the pool holds "
                    f"{self.allocator.capacity_blocks}")
            self.queue.append(req)
            return
        if self.role == "decode":
            raise ValueError(
                "role='decode' engine only accepts handoff requests; "
                "route raw prompts to the prefill pool")
        plen = admit_length(len(req.prompt), self.max_len)
        # a prefill-role engine maps only the prompt's blocks: its slots
        # turn over at the export, so the decode budget's reach is the
        # decode pool's
        end_max = (plen if self.role == "prefill"
                   else min(plen + req.max_new_tokens, self.max_len))
        need = -(-end_max // self.block_size)
        if self.kv == "paged" and need > self.allocator.capacity_blocks:
            raise ValueError(
                f"request needs {need} KV blocks (prompt bucket {plen} "
                f"+ budget {req.max_new_tokens}) but the pool holds "
                f"{self.allocator.capacity_blocks}; admission could "
                f"never succeed — shrink the request or grow num_blocks")
        self.queue.append(req)

    # ------------------------------------------------------------------
    # slot-granular admission
    # ------------------------------------------------------------------

    def _admit(self):
        """Fill free slots from the queue: any free slot at once
        (continuous), or only once every slot is free (wave).  Pool
        pressure defers admission."""
        free = [i for i, m in enumerate(self.slot_meta) if m.rid == -1]
        if self.admission == "wave" and len(free) < self.slots:
            return
        for si in free:
            if not self.queue:
                break
            if not self._admit_into(si, self.queue[0]):
                break
            self.queue.popleft()

    def _admit_into(self, si: int, req: Request) -> bool:
        """Begin admission of one request into batch row `si` (a one-shot
        prefill, or a chunked job); the other slots' decode state stays
        untouched.  Returns False when the pool cannot hold the request
        yet."""
        if req.handoff is not None:
            return self._admit_handoff_into(si, req)
        # a one-shot admission's span ends at its first-token stamp
        t_admit = time.monotonic_ns() if spans.enabled else None
        plen = admit_length(len(req.prompt), self.max_len)
        bs = self.block_size
        padded = np.zeros((plen,), np.int32)
        padded[-len(req.prompt):] = req.prompt                # left-pad
        row, keys, nhit, shareable = [], [], 0, 0
        if self.kv == "paged":
            end_max = (plen if self.role == "prefill"
                       else min(plen + req.max_new_tokens, self.max_len))
            total_blocks = -(-end_max // bs)
            n_full = plen // bs
            # keep >= 1 prompt position outside the shared prefix
            shareable = min(n_full, (plen - 1) // bs)
            keys = (PrefixCache.block_keys(padded, bs, n_full)
                    if self.prefix is not None else [])
            hit = self.prefix.match(keys[:shareable]) if self.prefix else []
            need = total_blocks - len(hit)
            if self.allocator.available_blocks < need:
                if self.prefix is not None:
                    self.prefix.evict_unreferenced(
                        need - self.allocator.available_blocks)
                if self.allocator.available_blocks < need:
                    for bid in hit:                    # undo the match refs
                        self.allocator.free(bid)
                    self.blocked_admissions += 1
                    return False
            row = hit + [self.allocator.alloc() for _ in range(need)]
            self._slot_blocks[si] = list(row)
            nhit = len(hit)
            self.prefix_hit_tokens += nhit * bs
        self.prompt_tokens_total += plen
        self.slot_meta[si].rid = req.rid
        self._live[req.rid] = req

        if self.prefill_mode == "chunked":
            self._zero_ssm_rows(si)
            self._jobs.append(_PrefillJob(
                si=si, req=req, padded=padded, plen=plen, off=nhit * bs,
                row=row, keys=keys, nhit=nhit))
            return True

        tokens = torch.as_tensor(padded[None], device=self.device)
        logits, cache = self._run_prefill("prefill", self._prefill,
                                          self.params, tokens)
        nxt = int(torch.argmax(logits[0, -1]))                # admission-time
        if self.kv == "paged":
            _install_slot_paged(self.state, cache, si, plen, nxt, row, nhit,
                                bs)
            self._publish_prefix(keys, row, nhit, shareable)
            self._install_draft(tokens, row, nhit)
        else:
            _install_slot(self.state, cache, si, plen, nxt)
        if self.role == "prefill":
            self._finish_prefill_export(si, req, plen, nxt, padded, keys)
        else:
            self._finish_admission(si, req, plen, nxt, t_admit)
        return True

    def _finish_admission(self, si: int, req: Request, plen: int, nxt: int,
                          t_admit: int | None = None):
        """Make slot ``si`` decode ``req``; a one-shot admission that began
        at ``t_admit`` records its ``engine.admit`` span to the
        first-token stamp."""
        m = self.slot_meta[si]
        m.rid = req.rid
        m.active = True
        self.active[si] = True
        self.budget[si] = req.max_new_tokens
        self._host_pos[si] = plen
        req.tokens.append(nxt)
        t = time.monotonic_ns()
        req.first_token_s = t / 1e9 - req.submitted
        self._live[req.rid] = req
        if t_admit is not None:
            spans.record(spans.ENGINE_ADMIT, t_admit, t, rid=req.rid,
                         attr=plen)

    # ------------------------------------------------------------------
    # disaggregated serving: KV block export (prefill) / import (decode)
    # ------------------------------------------------------------------

    def kv_fingerprint(self) -> tuple:
        """Pool-layout identity a handoff must match: the block size and
        each layer's paged keys with their per-block shapes and torch
        dtypes.  Two engines agree iff a block gathered from one scatters
        into the other unchanged."""
        if self.kv != "paged":
            raise ValueError("the fingerprint is a paged-pool property")
        layers = tuple(
            tuple(sorted((k, (v.shape[0],) + tuple(v.shape[2:]), str(v.dtype))
                         for k, v in leaf.items() if k in _PAGED_KEYS))
            for leaf in self.state["cache"])
        return (self.block_size, layers)

    def _finish_prefill_export(self, si: int, req: Request, plen: int,
                               nxt: int, padded: np.ndarray, keys: list):
        """Prefill-role completion: gather the slot's prompt blocks into
        host buffers (one device buffer, one host pull), attach the
        chain-hash keys and the admission token, and finish the request;
        the slot and its blocks turn over at once."""
        bs = self.block_size
        n_pb = -(-plen // bs)
        if not keys:
            # prefix sharing may be off here, but the decode pool still
            # wants the keys to republish: they depend on the tokens only
            keys = PrefixCache.block_keys(padded, bs, plen // bs)
        t0 = time.monotonic()
        bufs = _gather_blocks(self.state["cache"],
                              self._slot_blocks[si][:n_pb], self.device)
        self._export_ms.append((time.monotonic() - t0) * 1e3)
        req.handoff = KVHandoff(
            rid=req.rid, prompt=np.asarray(req.prompt, np.int32),
            plen=plen, first_token=nxt, max_new_tokens=req.max_new_tokens,
            block_hashes=tuple(keys), fingerprint=self.kv_fingerprint(),
            blocks=bufs)
        self._handoff_bytes.append(req.handoff.nbytes)
        now = time.monotonic()
        req.tokens.append(nxt)
        req.first_token_s = now - req.submitted
        req.done_s = now - req.submitted
        self.prefills_exported += 1
        self._live.pop(req.rid, None)
        self.done[req.rid] = req
        self._evict_slot(si)

    def _admit_handoff_into(self, si: int, req: Request) -> bool:
        """Decode-role admission: scatter an imported block chain into this
        pool and resume at the first generated token.  The slot is left
        EXACTLY as `_finish_admission` leaves a unified engine's (``pos =
        plen``, ``token = first_token``, the prompt's KV in rows
        ``0..plen-1``), so the greedy stream continues bitwise.  Prefix-hit
        blocks are not written, and fresh full blocks are republished under
        the handoff's own keys: sharing crosses the pool boundary."""
        h = req.handoff
        bs = self.block_size
        plen = h.plen
        end_max = min(plen + req.max_new_tokens, self.max_len)
        total_blocks = -(-end_max // bs)
        shareable = min(plen // bs, (plen - 1) // bs)
        keys = list(h.block_hashes)
        hit = self.prefix.match(keys[:shareable]) if self.prefix else []
        need = total_blocks - len(hit)
        if self.allocator.available_blocks < need:
            if self.prefix is not None:
                self.prefix.evict_unreferenced(
                    need - self.allocator.available_blocks)
            if self.allocator.available_blocks < need:
                for bid in hit:                    # undo the match refs
                    self.allocator.free(bid)
                self.blocked_admissions += 1
                return False
        row = hit + [self.allocator.alloc() for _ in range(need)]
        self._slot_blocks[si] = list(row)
        nhit = len(hit)
        self.prefix_hit_tokens += nhit * bs
        self.prompt_tokens_total += plen
        self.slot_meta[si].rid = req.rid
        t0 = time.monotonic()
        _import_blocks_paged(self.state, h.blocks, si, plen, h.first_token,
                             row, nhit, bs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._import_ms.append((time.monotonic() - t0) * 1e3)
        self._publish_prefix(keys, row, nhit, shareable)
        self.handoffs_imported += 1
        m = self.slot_meta[si]
        m.active = True
        self.active[si] = True
        self.budget[si] = req.max_new_tokens
        self._host_pos[si] = plen
        if not req.tokens:
            # the stream starts with the prefill's admission token; a
            # replayed import (requeued from the handoff) gets it again on
            # the fresh Request the dispatcher rebuilt
            req.tokens.append(h.first_token)
        req.first_token_s = time.monotonic() - req.submitted
        self._live[req.rid] = req
        return True

    def _dummy_handoff(self, plen: int) -> KVHandoff:
        """A zero-KV handoff shaped as a real one of bucket ``plen``:
        `warm_install` feeds these through the import scatter so a decode
        server takes its first-use costs before it takes leases."""
        bs = self.block_size
        n_pb = -(-plen // bs)
        prompt = (np.arange(max(plen - 1, 1)) % self.cfg.vocab_size).astype(
            np.int32)
        padded = np.zeros((plen,), np.int32)
        padded[-len(prompt):] = prompt
        blocks = [
            {k: np.zeros((v.shape[0], n_pb) + tuple(v.shape[2:]),
                         _wire_dtype(v.dtype))
             for k, v in leaf.items() if k in _PAGED_KEYS}
            for leaf in self.state["cache"]]
        return KVHandoff(
            rid=-2, prompt=prompt, plen=plen, first_token=0,
            max_new_tokens=1,
            block_hashes=tuple(PrefixCache.block_keys(padded, bs, plen // bs)),
            fingerprint=self.kv_fingerprint(), blocks=blocks)

    def _publish_prefix(self, keys, row, nhit: int, shareable: int):
        """Register freshly filled full blocks, capped at the matchable
        range (the block holding the last prompt position is never
        matched, so publishing it would only pin capacity)."""
        if self.prefix is None:
            return
        for j in range(nhit, shareable):
            self.prefix.publish(keys[j], row[j])

    def _install_draft(self, tokens, row, nhit: int):
        """Prompt-prefill the DRAFT model for a freshly admitted request and
        scatter its KV into the draft pools at the same physical block ids
        the target admission mapped.  Prefix-hit blocks are skipped: the
        admission that published a shared block already left bit-identical
        draft KV there (draft prefill is deterministic), and writing it
        again would write a shared block twice."""
        if self.spec != "draft":
            return
        _, dcache = self._run_prefill("draft_prefill", self._draft_prefill,
                                      self.draft_params, tokens)
        _install_draft_paged(self._draft_cache, dcache, row, nhit,
                             self.block_size)

    def _zero_ssm_rows(self, si: int):
        """Chunked prefill scans SSM layers from the row's cached state, so
        a new request starts that row from zeros, in place (paged and ring
        attention rows need no reset: stale entries are masked or
        overwritten)."""
        for leaf in self.state["cache"]:
            if "conv" in leaf:
                for v in leaf.values():
                    v[:, si] = 0

    # ------------------------------------------------------------------
    # chunked prefill: at most ONE chunk per engine tick
    # ------------------------------------------------------------------

    def _prefill_tick(self):
        if not self._jobs:
            return
        job = self._jobs[0]
        # chunk boundaries at absolute multiples of the chunk keep the set
        # of chunk shapes closed under prefix-hit offsets
        C = min(self.prefill_chunk - job.off % self.prefill_chunk,
                job.plen - job.off)
        toks = torch.as_tensor(job.padded[None, job.off:job.off + C],
                               device=self.device)
        # a dense cache has no blocks: the table row is a 1-wide dummy no
        # cache leaf indexes
        row_arr = np.zeros((max(self.max_blocks_per_slot, 1),), np.int32)
        row_arr[:len(job.row)] = job.row
        row_t = torch.as_tensor(row_arr, device=self.device)
        logits = self._run_chunk(toks, row_t, job.si, job.off)
        self.prefill_chunks += 1
        job.off += C
        if job.off < job.plen:
            return
        # the last chunk landed: install the block-table row and flip the
        # slot to decoding
        nxt = int(torch.argmax(logits[0]))                    # admission-time
        if self.kv == "paged":
            self.state["block_tables"][job.si] = row_t
        self.state["token"][job.si, 0] = nxt
        self.state["pos"][job.si] = job.plen
        # the draft's prompt KV lands in one shot on the last chunk's tick
        self._install_draft(torch.as_tensor(job.padded[None],
                                            device=self.device),
                            job.row, job.nhit)
        bs = self.block_size
        self._publish_prefix(job.keys, job.row, 0,
                             min(job.plen // bs, (job.plen - 1) // bs))
        self._jobs.popleft()
        if self.role == "prefill":
            self._finish_prefill_export(job.si, job.req, job.plen, nxt,
                                        job.padded, job.keys)
        else:
            self._finish_admission(job.si, job.req, job.plen, nxt)

    def _guard_rows(self):
        """Snapshot the PER-ROW cache leaves (dense rings, SSM rows) of
        every mid-admission slot.  The scratch block only shields paged
        pools from a free slot's writes; the batched decode step advances
        per-row state unconditionally, which would corrupt a half-prefilled
        request between chunks.  Written back right after the step
        (`_restore_rows`)."""
        idx = torch.as_tensor(sorted({job.si for job in self._jobs}),
                              device=self.device)
        snap = [(t, t[:, idx.to(t.device)]) for leaf in self.state["cache"]
                for k, v in leaf.items() if k not in _PAGED_KEYS
                for t in parts(v)]
        return (idx, snap) if snap else None

    @staticmethod
    def _restore_rows(guard):
        idx, snap = guard
        for dst, rows in snap:
            dst[:, idx.to(dst.device)] = rows

    def _evict_slot(self, si: int):
        # Frontier truncation doubles as the speculative rollback: a cancel
        # or eviction can land MID-VERIFY, with draft/verify KV written up
        # to spec_k positions past the committed frontier (in the target
        # and the shadow draft pools).  Speculation never allocates
        # (admission maps the request's whole reach), so every frontier
        # extension lives in blocks this row already owns or in the
        # scratch block; freeing `_slot_blocks` releases all of them and
        # zeroing the table row makes the stale entries unreachable.  One
        # free per admission-time alloc/share, nothing left to leak.
        m = self.slot_meta[si]
        if self.kv == "paged":
            for bid in self._slot_blocks[si]:
                self.allocator.free(bid)
            self._slot_blocks[si] = []
            self.state["block_tables"][si] = 0
        m.rid = -1
        m.active = False
        self._host_pos[si] = 0

    # ------------------------------------------------------------------
    # per-request drain/export
    # ------------------------------------------------------------------

    @_on_device
    def cancel(self, rid: int) -> Request | None:
        """Remove request ``rid`` from the queue or its decode slot and
        return it (tokens so far intact); evicting a slot returns every
        block it owned.  None when the engine does not hold ``rid``."""
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                del self.queue[i]
                return r
        # a mid-admission job holds a slot and blocks before it decodes:
        # check it before slot_meta so the job dies with them
        for j, job in enumerate(self._jobs):
            if job.req.rid == rid:
                del self._jobs[j]
                self._live.pop(rid, None)
                self._evict_slot(job.si)
                return job.req
        for si, m in enumerate(self.slot_meta):
            if m.rid == rid:
                req = self._live.pop(rid, None)
                self.active[si] = False
                self._evict_slot(si)
                return req
        return None

    def drain_requests(self) -> list[Request]:
        """Evict every queued, mid-admission or decoding request and return
        them."""
        rids = dict.fromkeys([r.rid for r in self.queue]
                             + [j.req.rid for j in self._jobs]
                             + [m.rid for m in self.slot_meta if m.rid != -1])
        return [r for r in (self.cancel(rid) for rid in rids) if r is not None]

    def step(self) -> int:
        """One engine iteration: admit into free slots, advance at most one
        prefill chunk, then one batched decode step (the graph's replay,
        the eager step, or one draft-and-verify step).  Returns the number
        of tokens committed to live requests.  The tick's time (ITL) starts
        before the device lock is taken: a wait for another thread's device
        work (a prefetch's warm-up) is part of the gap between tokens.  The
        same two stamps bound the ``engine.step`` span (an idle tick's ends
        when the lock is released) and are ``last_step_ns``; the span's
        children are each one-shot admission (``engine.admit``) and the
        decode half (``engine.decode``)."""
        t_tick = time.monotonic_ns()
        on = spans.enabled
        sid = spans.begin(spans.ENGINE_STEP, t_tick) if on else -1
        emitted, t_end = self._step(t_tick, on)
        if t_end is None:
            t_end = time.monotonic_ns()
        self.last_step_ns = (t_tick, t_end)
        if on:
            spans.end(sid, t_end)
        return emitted

    @_on_device
    def _step(self, t_tick: int, traced: bool) -> tuple[int, int | None]:
        """`step` under the device lock: the tokens committed and the
        tick's end stamp (None when no slot decoded)."""
        self._admit()
        self._prefill_tick()
        actives = [si for si, m in enumerate(self.slot_meta) if m.active]
        if not actives:
            return 0, None
        t_decode = time.monotonic_ns() if traced else 0
        guard = self._guard_rows() if self._jobs else None
        if self.spec == "draft":
            packed = self._spec_step()
        elif self._graph is not None:
            packed = self._graph.replay()
        else:
            packed = self._step_fn(self.params, self.state, self.active,
                                   self.budget)
        if guard is not None:
            self._restore_rows(guard)
        self.steps += 1
        self.idle_slot_steps += self.slots - len(actives)
        # lint: allow[one-transfer] -- THE one device->host copy of a step
        out = packed.cpu().numpy()
        self.d2h_transfers += 1
        if self.spec == "draft":
            acc, dones, tok_rows = out[0], out[1], out[2:]
            if self._draft_events is not None:
                self.draft_time_s += (self._draft_events[0].elapsed_time(
                    self._draft_events[1]) / 1e3)
        else:
            acc = np.ones((self.slots,), np.int64)
            dones, tok_rows = out[1], out[:1]
        emitted = 0
        for si in actives:
            self._host_pos[si] += int(acc[si])
            emitted += int(acc[si])
        self._sample_kv_pressure()         # before evictions
        now = time.monotonic()
        for si in actives:
            meta = self.slot_meta[si]
            req = self._live[meta.rid]
            req.tokens.extend(int(tok_rows[s][si])
                              for s in range(int(acc[si])))
            if dones[si]:
                req.done_s = now - req.submitted
                self.done[req.rid] = req
                del self._live[meta.rid]
                self._evict_slot(si)
        if self.spec == "draft":
            self.spec_drafted += self.spec_k * len(actives)
            # of each slot's a committed tokens, a-1 were draft proposals
            # the target ratified; the last is the target's own next token
            self.spec_accepted += emitted - len(actives)
        self.tokens_emitted += emitted
        t_end = time.monotonic_ns()
        self._tick_times.append((t_end - t_tick) / 1e9)
        if traced:
            spans.record(spans.ENGINE_DECODE, t_decode, t_end)
        return emitted, t_end

    def _spec_step(self):
        """The draft chain, then the verify step (their graphs' replays on
        a graphed engine); returns the packed (k+3, slots) tensor.  The
        drafts stay on the device and feed verify directly; nothing is read
        back here, and the draft cache is written in place.  On a card the
        chain's time is taken with CUDA events around its replay (or its
        eager run), read after the step's one copy (which waits for the
        device); on the CPU every op is synchronous and the host clock
        measures it."""
        cuda = self.device.type == "cuda"
        if cuda:
            self._draft_events = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
            self._draft_events[0].record()
        else:
            t0 = time.monotonic()
        if self._spec_graphs is not None:
            drafts = self._spec_graphs[0].replay()
        else:
            drafts, _ = self._draft_fn(
                self.draft_params, self._draft_cache, self.state["token"],
                self.state["pos"], self.state["block_tables"])
        if cuda:
            self._draft_events[1].record()
        else:
            self.draft_time_s += time.monotonic() - t0
        if self._spec_graphs is not None:
            return self._spec_graphs[1].replay()
        return self._verify_fn(self.params, self.state, self.active,
                               self.budget, drafts)

    def warm_admission(self):
        """Run one prefill per admit-length bucket ahead of the first
        request, and (chunked mode) one chunk per chunk shape, so first-use
        costs (kernel compiles, library handles, and on a graphed engine
        each bucket's and chunk shape's capture) do not land on a live
        request.  Each bucket and each chunk shape takes the device lock
        on its own: a fleet's joiner warms up while its peers serve, and
        they renew their leases between its captures.  The chunks target
        an all-scratch table row in slot 0 (paged: their writes land in
        the scratch block); the SSM rows they advance are zeroed after."""
        if self._live or self._jobs:
            raise RuntimeError("warm_admission needs an idle engine")
        if self.role == "decode":
            return                     # no prefill to warm
        # the largest bucket first: its output is the one the others share
        for pb in reversed(admit_buckets(self.max_len)):
            self._warm_bucket(pb)
        if self.prefill_mode == "chunked":
            for C in prefill_chunk_shapes(self.max_len, self.block_size,
                                          self.prefill_chunk):
                self._warm_chunk(C)

    @_on_device
    def _warm_bucket(self, pb: int):
        tokens = torch.zeros((1, pb), dtype=torch.int32, device=self.device)
        self._run_prefill("prefill", self._prefill, self.params, tokens)
        if self.spec == "draft":
            self._run_prefill("draft_prefill", self._draft_prefill,
                              self.draft_params, tokens)
        self._sync()

    @_on_device
    def _warm_chunk(self, C: int):
        row = torch.zeros((max(self.max_blocks_per_slot, 1),),
                          dtype=torch.int32, device=self.device)
        self._run_chunk(torch.zeros((1, C), dtype=torch.int32,
                                    device=self.device), row, 0, 0)
        self._zero_ssm_rows(0)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_install(self):
        """Run one real admission, decode step and eviction per admit
        bucket over dummy requests (rid -2, -3, ...), then flush the
        prefix cache's dummy blocks and `reset_metrics`.  `warm_admission`
        runs each bucket's prefill; this runs what surrounds it (the block
        scatter, the table writes, the decode step and the packed step's
        unpack), so their first-use costs land before a fleet server takes
        leases: one tick held past the lease TTL makes the pool requeue
        what the server just fetched.  A decode-role engine admits through
        the import scatter, so its dummies are zero-KV handoffs
        (`_dummy_handoff`)."""
        assert not self._live and not self.queue and not self._jobs, \
            "warm on an idle engine"
        for i, pb in enumerate(admit_buckets(self.max_len)):
            try:
                # rid -1 is the free-slot sentinel: dummies start at -2
                if self.role == "decode":
                    h = self._dummy_handoff(pb)
                    self.submit(Request(rid=-2 - i, prompt=h.prompt,
                                        max_new_tokens=1, handoff=h))
                    continue
                self.submit(Request(
                    rid=-2 - i,
                    prompt=(np.arange(pb) % self.cfg.vocab_size).astype(
                        np.int32),
                    max_new_tokens=1))
            except ValueError:
                continue                   # bucket exceeds this pool's reach
        self.run()
        if self.prefix is not None:
            # real prompts never match the dummies' blocks: drop them
            self.prefix.evict_unreferenced(self.allocator.capacity_blocks)
        self.reset_metrics()               # also drops the dummy results

    def reset_metrics(self):
        """Zero the counters and results between phases (after a warm-up
        run) without touching the step functions, the graph or slot state.
        Besides the reference's counters it zeroes the port's own: the tick
        samples behind ``itl_*`` and the engine's ``launches`` (the graph's
        warm-up launches stay in ``graph_warm_launches``), so a fleet
        server's stats describe its live traffic only."""
        assert not self._live and not self.queue and not self._jobs, \
            "engine still has work"
        self.steps = 0
        self.idle_slot_steps = 0
        self.d2h_transfers = 0
        self.prefill_chunks = 0
        self.blocked_admissions = 0
        self.prefills_exported = 0
        self.handoffs_imported = 0
        self._export_ms = []
        self._import_ms = []
        self._handoff_bytes = []
        self.prompt_tokens_total = 0
        self.prefix_hit_tokens = 0
        self._kv_util_sum = 0.0
        self.kv_peak_live_tokens = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.tokens_emitted = 0
        self.draft_time_s = 0.0
        self._tick_times = []
        self.launches.clear()
        if self.prefix is not None:
            self.prefix.lookups = 0
            self.prefix.hits = 0
        self.done.clear()

    def block_leaks(self) -> int:
        """KV block leak audit for an IDLE engine: drops the prefix cache's
        unreferenced blocks and returns how many blocks remain allocated
        (zero when every admit/cancel path balanced its refcounts; always
        zero for a dense cache, which has no blocks)."""
        if self.kv != "paged":
            return 0
        assert not self._live and not self.queue, \
            "block_leaks() on a busy engine"
        if self.prefix is not None:
            self.prefix.evict_unreferenced(self.allocator.capacity_blocks)
        return self.allocator.allocated_blocks

    def kv_pool_bytes(self) -> dict:
        """KV cache memory: the logical total and one rank's footprint
        (rank 0's parts of the split leaves, the replicated leaves whole).
        On a 1xN mesh the head-split pools put ~1/N of the pool bytes on
        each rank — the capacity headroom tensor parallelism buys."""
        total = local = 0
        for leaf in self.state["cache"]:
            for t in leaf.values():
                ps = parts(t)
                total += sum(p.numel() * p.element_size() for p in ps)
                local += ps[0].numel() * ps[0].element_size()
        return {"kv_pool_bytes": total, "kv_pool_bytes_per_device": local}

    def device_bytes(self) -> dict:
        """The parameter, decode-state and KV-pool bytes held on each
        device of the engine's mesh, ``[data row][model rank]`` (a
        one-device engine: ``[[n]]``), as `launch.dryrun.run_serve_cell`
        predicts them with ``whole=`` the leaves kept whole; and
        ``graphs``, the bytes its CUDA graphs hold on its one device
        (`graph_bytes`; 0 when eager), which the dry run does not
        predict."""
        msz = (1 if self.mesh is None
               else len(self.mesh.model_devices))
        params = (self.params.tree(),) + tuple(
            getattr(self.params, "replicas", ()))
        states = (self.state,) + tuple(self.state_replicas)
        kv = (*_PAGED_KEYS, *_RING_KEYS)
        return {
            "params": [rank_bytes(t, msz) for t in params],
            "state": [rank_bytes(t, msz) for t in states],
            "kv_pool": [rank_bytes(t["cache"], msz, kv) for t in states],
            "graphs": self.graph_bytes()}

    def _live_tokens(self) -> int:
        return sum(self._host_pos[si]
                   for si, m in enumerate(self.slot_meta) if m.active)

    def kv_pressure(self) -> dict:
        """Instantaneous cache-pressure sample for heartbeat telemetry."""
        live = self._live_tokens()
        allocated = self._allocated_tokens()
        return {
            "kv": self.kv,
            "role": self.role,
            "prefills_exported": self.prefills_exported,
            "handoffs_imported": self.handoffs_imported,
            "kv_memory_utilization": live / allocated if allocated else 0.0,
            "kv_live_tokens": live,
            "kv_peak_live_tokens": self.kv_peak_live_tokens,
            "kv_capacity_tokens": self.kv_capacity_tokens,
            # a mesh-bound server is ONE unit of `slots` capacity however
            # many devices back it (the pools are split, not replicated)
            "slots": self.slots,
            "mesh_devices": self.mesh_devices,
            "mesh_shape": self._mesh_shape(),
            "prefix_hit_rate": (self.prefix_hit_tokens
                                / self.prompt_tokens_total
                                if self.prompt_tokens_total else 0.0),
            "acceptance_rate": (self.spec_accepted / self.spec_drafted
                                if self.spec_drafted else 0.0),
            "tokens_per_step": (self.tokens_emitted / self.steps
                                if self.steps else 0.0),
        }

    def _warm_launches(self) -> dict:
        out: dict = {}
        for g in self._graphs():
            for name, n in g.warm_launches.items():
                out[name] = out.get(name, 0) + n
        return out

    def _mesh_shape(self):
        return (tuple(self.mesh.devices.shape) if self.mesh is not None
                else None)

    def _allocated_tokens(self) -> int:
        if self.kv == "paged":
            return self.allocator.allocated_blocks * self.block_size
        return self.slots * self.max_len

    def _sample_kv_pressure(self):
        live = self._live_tokens()
        allocated = self._allocated_tokens()
        if allocated:
            self._kv_util_sum += live / allocated
        self.kv_peak_live_tokens = max(self.kv_peak_live_tokens, live)

    # ------------------------------------------------------------------

    def run(self, *, max_steps: int = 10_000) -> dict:
        t0 = time.monotonic()
        decoded = ticks = 0
        while ((self.queue or self._live or self._jobs)
               and self.steps < max_steps and ticks < max_steps):
            decoded += self.step()
            ticks += 1
        return self._stats(decoded, time.monotonic() - t0)

    def run_trace(self, trace, *, max_ticks: int = 100_000,
                  on_tick=None) -> dict:
        """Drive the engine from a request trace with staggered arrivals:
        ``{"rid", "prompt": [ints], "max_new_tokens", "at_step"}`` dicts;
        a request becomes visible at tick ``at_step``.  ``on_tick(tick,
        step_seconds)`` (optional; ``step_seconds`` from `last_step_ns`)
        runs after every tick — the wrapper's heartbeat and stop hook;
        returning False ends the run."""
        pending = sorted(enumerate(trace),
                         key=lambda ie: int(ie[1].get("at_step", 0)))
        t0 = time.monotonic()
        decoded, tick, i = 0, 0, 0
        while i < len(pending) or self.queue or self._live or self._jobs:
            while i < len(pending) and int(pending[i][1].get("at_step", 0)) <= tick:
                idx, e = pending[i]
                i += 1
                self.submit(Request(
                    rid=int(e.get("rid", idx)),
                    prompt=np.asarray(e["prompt"], np.int32),
                    max_new_tokens=int(e.get("max_new_tokens", 16))))
            decoded += self.step()
            tick += 1
            t0_ns, t1_ns = self.last_step_ns
            if on_tick is not None and on_tick(
                    tick, (t1_ns - t0_ns) / 1e9) is False:
                break
            if tick >= max_ticks:
                break
        return self._stats(decoded, time.monotonic() - t0)

    def _stats(self, decoded: int, wall: float) -> dict:
        denom = self.steps * self.slots
        util = (denom - self.idle_slot_steps) / denom if self.steps else 0.0
        ttfts = [r.first_token_s for r in self.done.values()
                 if r.first_token_s is not None]
        tpots = [(r.done_s - r.first_token_s) / max(1, len(r.tokens) - 1)
                 for r in self.done.values()
                 if r.done_s is not None and r.first_token_s is not None
                 and len(r.tokens) > 1]
        pct = lambda v, q: float(np.percentile(v, q)) if v else None  # noqa: E731
        return {
            "completed": len(self.done),
            "role": self.role,
            "decode_steps": self.steps,
            "tokens_decoded": decoded,
            "slot_utilization": util,
            "idle_slot_steps": self.idle_slot_steps,
            "d2h_transfers": self.d2h_transfers,
            "wall_s": wall,
            "tok_per_s": decoded / wall if wall else 0.0,
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else None,
            "ttft_p50_s": pct(ttfts, 50),
            "ttft_p99_s": pct(ttfts, 99),
            "tpot_p50_s": pct(tpots, 50),
            "tpot_p99_s": pct(tpots, 99),
            "itl_p50_s": pct(self._tick_times, 50),
            "itl_p99_s": pct(self._tick_times, 99),
            "itl_max_s": max(self._tick_times, default=None),
            "kv": self.kv,
            "kv_memory_utilization": (self._kv_util_sum / self.steps
                                      if self.steps else 0.0),
            "kv_peak_live_tokens": self.kv_peak_live_tokens,
            "kv_capacity_tokens": self.kv_capacity_tokens,
            "prefix_hit_rate": (self.prefix_hit_tokens
                                / self.prompt_tokens_total
                                if self.prompt_tokens_total else 0.0),
            "prefill": self.prefill_mode,
            "prefill_chunks": self.prefill_chunks,
            # the one switch: every function the reference compiles is
            # a replayed CUDA graph (step_graph), and which of them ran
            "step_graph": self.step_graph,
            "decode_graph": self._graph is not None,
            "spec_graph": self._spec_graphs is not None,
            "prefill_graph": sorted(self._admit_ran["prefill"]),
            "draft_prefill_graph": sorted(self._admit_ran["draft_prefill"]),
            "chunk_graph": sorted(self._admit_ran["chunk"]),
            # the device memory the captures hold (`graph_bytes`)
            "graph_pool_bytes": self.graph_bytes(),
            # launches of the throwaway warm-up steps run before the
            # decode step's and the spec pair's captures (a graph captured
            # at first use warms up on that use, which an eager engine
            # makes too)
            "graph_warm_launches": self._warm_launches(),
            "blocked_admissions": self.blocked_admissions,
            "spec": self.spec,
            "spec_k": self.spec_k if self.spec != "off" else 0,
            "spec_fallback_reason": self.spec_fallback_reason,
            "acceptance_rate": (self.spec_accepted / self.spec_drafted
                                if self.spec_drafted else 0.0),
            "tokens_per_step": decoded / self.steps if self.steps else 0.0,
            "draft_overhead_s": self.draft_time_s,
            # tensor-parallel footprint: shape None == single device
            "mesh_shape": self._mesh_shape(),
            "mesh_devices": self.mesh_devices,
            # the port's own: the column leaves kept whole on the lead
            # device (their slices were not bitwise the whole product's)
            "mesh_whole_leaves": (list(self.params.whole_leaves)
                                  if self.mesh is not None else []),
            "slots": self.slots,
            **self.kv_pool_bytes(),
            "prefills_exported": self.prefills_exported,
            "handoffs_imported": self.handoffs_imported,
            # the port's own: each handoff's host ms and wire bytes
            "handoff_export_ms": list(self._export_ms),
            "handoff_import_ms": list(self._import_ms),
            "handoff_bytes": list(self._handoff_bytes),
            "launches": dict(self.launches),
            "device": str(self.device),
        }


# --------------------------------------------------------------------------


def _install_slot(state, prefill_cache, slot: int, plen: int,
                  next_token: int):
    """Install a one-shot prefill into row ``slot`` of the DENSE decode
    state IN PLACE: each ring row takes the prefill's rows (zeros past
    them), each SSM state row (``conv``, ``ssd``) the prefill's whole row,
    then the slot's token and position are set."""
    for st_leaf, pf_leaf in zip(state["cache"], prefill_cache):
        for key, dst in st_leaf.items():
            for d, src in pairs(dst, pf_leaf[key]):
                _merge_row(d, src, slot, ring=key in _RING_KEYS)
    state["token"][slot, 0] = next_token
    state["pos"][slot] = plen
    return state


def _merge_row(dst, src, slot: int, ring: bool = True):
    """Write prefill leaf ``src`` (groups, 1, ...) into row ``slot`` of the
    engine leaf ``dst`` (groups, B, ...) in place.  A ring (groups, B, T,
    ...) takes the prefill's T' rows cropped or zero-padded to T; a
    per-row state leaf (``ring=False``) has the engine's shape and is
    written whole."""
    if not ring:
        dst[:, slot] = src[:, 0].to(dst.dtype)
        return dst
    rows = src[:, 0, :dst.shape[2]]
    dst[:, slot, :rows.shape[1]] = rows.to(dst.dtype)
    dst[:, slot, rows.shape[1]:] = 0
    return dst


def _install_slot_paged(state, prefill_cache, slot: int, plen: int,
                        next_token: int, row: list, nhit: int,
                        block_size: int):
    """Install a one-shot prefill into the paged decode state IN PLACE:
    scatter the dense prefill rows into the slot's fresh blocks (prefix-hit
    blocks already hold bit-identical content and are not written), write
    the per-row leaves (sliding-window rings, SSM rows) into batch row
    ``slot`` as `_install_slot` does, then set the slot's token, position
    and block-table row."""
    for st_leaf, pf_leaf in zip(state["cache"], prefill_cache):
        for key, dst in st_leaf.items():
            for d, src in pairs(dst, pf_leaf[_PAGED_KEYS.get(key, key)]):
                if key in _PAGED_KEYS:
                    _scatter_blocks(d, src, row, nhit, block_size)
                else:
                    _merge_row(d, src, slot, ring=key in _RING_KEYS)
    mb = state["block_tables"].shape[1]
    row_arr = np.zeros((mb,), np.int32)
    row_arr[:len(row)] = row
    state["token"][slot, 0] = next_token
    state["pos"][slot] = plen
    state["block_tables"][slot] = torch.from_numpy(row_arr)
    return state


def _install_draft_paged(cache, prefill_cache, row: list, nhit: int,
                         block_size: int):
    """Scatter a DRAFT-model prefill into the draft's shadow block pools IN
    PLACE, at the same physical ids the target admission mapped (hit
    blocks untouched).  Spec eligibility makes every draft leaf paged."""
    for st_leaf, pf_leaf in zip(cache, prefill_cache):
        for key, pool in st_leaf.items():
            for d, src in pairs(pool, pf_leaf[_PAGED_KEYS[key]]):
                _scatter_blocks(d, src, row, nhit, block_size)
    return cache


def _scatter_blocks(pool, src, row: list, nhit: int, block_size: int):
    """Scatter a dense prefill leaf (groups, 1, T', ...) into pool blocks
    (groups, nb, bs, ...) ``row[nhit:]`` in place (hit blocks untouched).
    Rows past the slot's blocks are dropped: a VLM's text-only prefill
    allocates its cache ``frontend_tokens`` longer than the prompt, and
    those rows are zeros past every position the slot can reach."""
    rows = src[:, 0]                                  # (groups, T', ...)
    Tp = rows.shape[1]
    n_pb = -(-Tp // block_size)
    if nhit >= n_pb:
        return pool
    pad = n_pb * block_size - Tp
    if pad:
        rows = torch.nn.functional.pad(
            rows, (0, 0) * (rows.dim() - 2) + (0, pad))
    rows = rows.reshape((rows.shape[0], n_pb, block_size) + rows.shape[2:])
    ids = torch.as_tensor(np.asarray(row[nhit:n_pb], np.int64),
                          device=pool.device)
    pool[:, ids] = rows[:, nhit:nhit + len(ids)].to(pool.dtype)
    return pool


def _wire_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a pool of ``dtype`` travels as in a handoff: bf16,
    which numpy lacks, as its raw 16-bit pattern (int16)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _ids_on(ids: np.ndarray):
    """``device -> ids`` as a tensor there, each device's copied once (one
    host-to-device copy a rank, not one a pool)."""
    on = {}

    def get(device: torch.device) -> torch.Tensor:
        if device not in on:
            on[device] = torch.as_tensor(ids, device=device)
        return on[device]
    return get


def _gather_blocks(cache, row: list, device: torch.device) -> list:
    """The export half of the KV handoff: gather a slot's block chain out
    of every layer's paged pools on the device (``index_select``; a pool
    split over a mesh's ranks gathers on each rank and concatenates the
    parts on ``device`` along its split dim, the one-device layout), pack
    every gathered leaf's bytes into ONE device buffer and pull it to the
    host once.  Returns one dict per layer of host buffers ``(groups,
    n_pb, bs, ...)`` in their wire dtype (`_wire_dtype`)."""
    leaves, chunks = [], []
    ids = _ids_on(np.asarray(row, np.int64))
    for li, leaf in enumerate(cache):
        for k, pool in leaf.items():
            if k not in _PAGED_KEYS:
                continue
            got = [p.index_select(1, ids(p.device)).to(device)
                   for p in parts(pool)]
            blocks = (torch.cat(got, dim=pool.dim)
                      if isinstance(pool, Shards) else got[0])
            leaves.append((li, k, tuple(blocks.shape), pool.dtype))
            chunks.append(blocks.reshape(-1).view(torch.uint8))
    host = torch.cat(chunks).cpu().numpy()              # THE one host pull
    out = [{} for _ in cache]
    off = 0
    for (li, k, shape, dtype), part in zip(leaves, chunks):
        n = part.numel()
        out[li][k] = host[off:off + n].view(_wire_dtype(dtype)).reshape(shape)
        off += n
    return out


def _import_blocks_paged(state, bufs: list, slot: int, plen: int,
                         next_token: int, row: list, nhit: int,
                         block_size: int):
    """The import half of the KV handoff, IN PLACE: copy each handoff
    buffer (per layer, ``(groups, n_pb, bs, ...)`` in its wire dtype) to
    the device, view it as its pool's dtype and scatter it into blocks
    ``row[nhit:n_pb]`` (``index_copy_``; prefix-hit blocks already hold
    bit-identical content); a pool split over a mesh's ranks takes each
    rank's slice of the buffer into its part (`pairs`).  Then write the
    slot's block-table row, token and position.  Nothing in ``state`` is
    rebound: a captured decode step replays its fixed addresses."""
    n_pb = -(-plen // block_size)
    dev = state["token"].device
    ids = _ids_on(np.asarray(row[nhit:n_pb], np.int64))
    for st_leaf, hb in zip(state["cache"], bufs if nhit < n_pb else ()):
        for key, buf in hb.items():
            pool = st_leaf[key]
            buf = np.ascontiguousarray(buf[:, nhit:])
            if not buf.flags.writeable:    # torch takes no read-only array
                buf = buf.copy()
            src = torch.from_numpy(buf).to(dev).view(pool.dtype)
            for d, s in pairs(pool, src):
                d.index_copy_(1, ids(d.device), s)
    mb = state["block_tables"].shape[1]
    row_arr = np.zeros((mb,), np.int32)
    row_arr[:len(row)] = row
    state["token"][slot, 0] = next_token
    state["pos"][slot] = plen
    state["block_tables"][slot] = torch.from_numpy(row_arr)
    return state
