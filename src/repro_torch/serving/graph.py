"""The engine's decode step as one captured CUDA graph.

The JAX engine compiles its decode step once (``jax.jit`` with the decode
state donated); this is the port's counterpart.  The eager step makes
about a thousand kernel launches from Python (``PERF.md``), and the card
waits on the host between them; a replayed graph launches them all in one
call.

A graph replays fixed addresses, so the step it captures must read and
write only tensors that live as long as the graph: the engine's caches,
``token``, ``pos``, ``block_tables``, ``active`` and ``budget``, all
written in place by the step (``engine.make_engine_step``) and by the
host between steps (admission, eviction, block-table rows).  Its one
output, the packed ``(2, slots)`` tensor, is a static tensor the host
copies once per step.  A tensor-parallel engine whose ranks all live on
one device captures its step the same way: each rank's pools are written
in place, and the gathers between the ranks' parts allocate from the
graph's pool.  Across devices the step runs eagerly.

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

import torch

from repro_torch.analysis.locks import make_rlock
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_verify_attention)
from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
from repro_torch.kernels.ssd_scan.ops import ssd_scan

WRAPPERS = (paged_decode_attention, paged_verify_attention, decode_attention,
            flash_attention, rmsnorm_fused, grouped_matmul, ssd_scan)

DEVICE_LOCK = make_rlock("serving.device")


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by wrapper name."""
    return {w.__name__: w.launches for w in WRAPPERS}


class StepGraph:
    """``fn()`` captured once on CUDA ``device`` and replayed.

    ``torch.cuda.graph`` wants the function run a few times on a side
    stream before the capture (libraries set up their handles and
    workspaces there); ``reset()`` then puts back whatever those runs
    changed that the caller cares about.  A capture that fails raises: the
    caller gets no graph and no eager stand-in."""

    def __init__(self, fn, device, reset, *, warmup: int = 3):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        with DEVICE_LOCK:
            self._capture(fn, device, reset, warmup)

    def _capture(self, fn, device, reset, warmup):
        before = [w.launches for w in WRAPPERS]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        reset()
        # the warm-up runs were launched on the device and stay counted
        self.warm_launches = {w.__name__: w.launches - n
                              for w, n in zip(WRAPPERS, before)}
        before = [w.launches for w in WRAPPERS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
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
