"""The reference's jit boundaries as captured CUDA graphs.

The JAX engine compiles its serve functions once and reuses them
(``jax.jit``; the decode step with the decode state donated); this is the
port's counterpart.  An eager step makes about a thousand kernel launches
from Python (``PERF.md``), and the card waits on the host between them; a
replayed graph launches them all in one call.  `StepGraph` captures a
function of no arguments: the engine's decode step, its draft chain and
verify step (captured at construction), and the decode image's step
(`repro_torch.launch.steps.make_serve_step`, captured per state).
`CallGraph` captures a function over static copies of its tensor
arguments, one per shape, at its first call: the engine's one-shot
admission prefill of each bucket (target and draft) and its chunk
function of each chunk length, whose slot and offset are 0-d device
tensors there.  The one-shot admission graphs of one model write their
outputs into a `SharedOutput`, so an engine holds one prefill cache, the
largest bucket's, and not one a bucket.

A graph replays fixed addresses, so the function it captures must read
and write only tensors that live as long as the graph: the engine's
caches, ``token``, ``pos``, ``block_tables``, ``active`` and ``budget``,
all written in place by the step (``engine.make_engine_step``) and by the
host between steps (admission, eviction, block-table rows), and a
`CallGraph`'s static inputs, which the host writes before each replay.
Each graph's outputs are static tensors its next replay overwrites.  A
tensor-parallel engine whose ranks all live on one device captures the
same way: each rank's pools are written in place, and the gathers
between the ranks' parts allocate from the graph's pool.  Across devices
everything runs eagerly.

The kernel wrappers count their launches in Python (``<wrapper>.launches``)
and a replay runs no Python, so `StepGraph` records each wrapper's count
during the capture (which launches nothing on the device) and adds it on
every replay: the counts keep meaning launches the device ran.

A pilot prefetches the next payload's image on a background thread while
the current payload serves (``core/images.py``), so device work can come
from two threads of one process.  ``torch.cuda.graph`` captures in its
"global" error mode: an unsafe CUDA call from any other thread during a
capture (an allocator ``cudaMalloc``, a synchronous copy) invalidates it,
and the launch-count bookkeeping above would lose another thread's
launches.  ``DEVICE_LOCK`` is the one process-wide lock over device work:
`StepGraph` holds it over its warm-up, capture and bookkeeping; the engine
over its construction, each step, its warm-up and a cancel; an image's
build and warm-up over theirs.  Launches made while it is held belong to
its holder, which is how an engine counts its own (`launch_counts`).
"""

from __future__ import annotations

import time

import torch
import torch.utils._pytree as pytree

from repro_torch.analysis.locks import make_rlock
from repro_torch.core import spans
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_verify_attention)
from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.runtime.sharding import Shards, parts

WRAPPERS = (paged_decode_attention, paged_verify_attention, decode_attention,
            flash_attention, rmsnorm_fused, grouped_matmul, ssd_scan)

DEVICE_LOCK = make_rlock("serving.device")


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by wrapper name."""
    return {w.__name__: w.launches for w in WRAPPERS}


class StepGraph:
    """``fn()`` captured once on CUDA ``device`` and replayed.

    ``torch.cuda.graph`` wants the function run on a side stream before the
    capture (libraries set up their handles and workspaces there).  With
    ``reset`` given, ``warmup`` throwaway runs go first and ``reset()`` then
    puts back whatever they changed that the caller cares about; their
    launches are reported apart (``warm_launches``).  Without it, ``fn`` runs
    once as the call that asked for the graph (the counterpart of a jit
    compile on first call): its result is ``first``, its launches are the
    caller's own, and nothing needs putting back.  ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) lets graphs whose outputs are
    consumed before another of them replays share one memory pool
    (`pool_bytes` reads what the pools hold).  A capture that fails
    raises: the caller gets no graph and no eager stand-in.  Each capture
    records a ``graph.capture`` span (`repro_torch.core.spans`), tagged
    ``kind`` with ``key`` (a shape) as its attribute."""

    def __init__(self, fn, device, reset=None, *, warmup: int = 3,
                 pool=None, kind: str = "step", key: int = 0):
        t0 = time.monotonic_ns()
        with DEVICE_LOCK:
            self._capture(fn, device, reset, warmup if reset else 1, pool)
        if spans.enabled:
            spans.record(spans.GRAPH_CAPTURE, t0, time.monotonic_ns(),
                         attr=key, tag=spans.intern(kind))

    def _capture(self, fn, device, reset, warmup, pool):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        before = [w.launches for w in WRAPPERS]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                self.first = fn()
        torch.cuda.current_stream(device).wait_stream(side)
        self.warm_launches = {}
        if reset is not None:
            self.first = None
            reset()
            # the warm-up runs were launched on the device and stay counted
            self.warm_launches = {w.__name__: w.launches - n
                                  for w, n in zip(WRAPPERS, before)}
        before = [w.launches for w in WRAPPERS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = fn()
        # the capture recorded these launches; the device ran none of them
        self.launches = {}
        for w, n in zip(WRAPPERS, before):
            if w.launches != n:
                self.launches[w] = w.launches - n
                w.launches = n

    def replay(self):
        """Run the captured step once; returns its static output."""
        self.graph.replay()
        for w, n in self.launches.items():
            w.launches += n
        return self.out


class CallGraph:
    """``fn(*args)`` captured over static copies of its tensor arguments,
    the counterpart of one jit-compiled shape: the capture is made by the
    first call (`CallGraph.first_call`, which returns that call's result),
    and each later call copies its arguments into the static buffers (the
    eager copies before a replay) and replays.  The caller keys one per
    shape."""

    def __init__(self, fn, args, device, *, pool=None, kind: str = "call",
                 key: int = 0):
        self.inputs = [torch.empty_like(a, device=device) for a in args]
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        inputs = self.inputs
        self.step = StepGraph(lambda: fn(*inputs), device, pool=pool,
                              kind=kind, key=key)

    @classmethod
    def first_call(cls, fn, args, device, *, pool=None, kind: str = "call",
                   key: int = 0):
        """Capture ``fn`` at ``args``; returns ``(graph, fn(*args))``."""
        g = cls(fn, args, device, pool=pool, kind=kind, key=key)
        first, g.step.first = g.step.first, None
        return g, first

    def __call__(self, *args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        return self.step.replay()


def _capturing(device) -> bool:
    """Whether the current stream of ``device`` is capturing a graph."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class SharedOutput:
    """The output of several graphs of one pool, one graph per shape,
    held once.  The first graph captured keeps its own output tensors (the
    ``ref``), and each later one copies its output into views of them,
    each leaf into the front of the same leaf of the ``ref``.  So only the
    last replay's output may be read: its caller reads it before another
    of the graphs replays, as it must read any of the pool's outputs.
    `place` is called by the captured function itself, in its warm-up and
    in its capture.  An output that does not fit (a leaf larger than the
    ``ref``'s, or another tree) is returned as it is, and under a capture
    it becomes the ``ref``: `generation` counts them, and the graphs that
    write into an older one are dropped by their owner, to be captured
    again at their next use.  Captured from the largest shape down, the
    graphs hold one output, the largest's."""

    def __init__(self):
        self.ref, self.generation = None, 0

    def _fits(self, leaves) -> bool:
        return self.ref is not None and len(leaves) == len(self.ref) and all(
            t.dtype == r.dtype and t.numel() <= r.numel()
            for t, r in zip(leaves, self.ref))

    def place(self, tree):
        """``tree`` copied into views of the ``ref`` when it fits; else
        ``tree`` itself (the new ``ref`` under a capture).  A `Shards`
        leaf (a tensor-parallel engine's, its ranks on one device) counts
        as its parts."""
        leaves, spec = pytree.tree_flatten(tree)
        flat = [p for x in leaves for p in parts(x)]
        if self._fits(flat):
            views = [r.view(-1)[:t.numel()].view(t.shape)
                     for r, t in zip(self.ref, flat)]
            for v, t in zip(views, flat):
                v.copy_(t)
            it = iter(views)
            out = [Shards([next(it) for _ in x.parts], x.dim)
                   if isinstance(x, Shards) else next(it) for x in leaves]
            return pytree.tree_unflatten(out, spec)
        # (a leaf that is not contiguous cannot be viewed flat: such an
        # output stays the graph's own)
        if flat and _capturing(flat[0].device) and all(
                t.is_contiguous() for t in flat):
            self.ref = flat
            self.generation += 1
        return tree


def pool_bytes(graphs) -> int:
    """The device memory the pools of ``graphs`` (`StepGraph`s) hold: the
    allocator's segments of those pools, each pool counted once however
    many graphs share it."""
    pools = {tuple(g.graph.pool()) for g in graphs}
    if not pools:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id") or ()) in pools)
