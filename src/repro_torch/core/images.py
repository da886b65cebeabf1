"""PayloadImage + ExecutableRegistry — container images and the image cache.

Port of ``repro.core.images``.  A *PayloadImage* names everything needed to
build the payload's executable: (architecture x input shape x step kind x
flags).  "Pulling" an image builds the model bundle and builds and loads
the kernel libraries its flags select (``kernels/_build.py``: nvcc at first
use, cached on disk under ``build/kernels/``); the registry's cache plays
the node's local image cache — a warm ``bind()`` skips the pull exactly as
a cached image does.  The reference keys its cache on the slice's mesh;
here the key holds the slice's device.

A train image binds the train step (`repro_torch.launch.steps`) with its
state and data builders; it runs the plain paths, so an image whose flags
select a hand-written kernel fails its pull: the kernels are forward only,
and the JAX package defines no VJP for any of them.

The PLACEHOLDER image is the paper's arbitrary default container image: a
trivial executable every slice can always run, installed at pod creation so
the Kubernetes-side object is valid before any payload exists (§3.3).

A prefetch builds and warms the next image on a background thread while the
current payload serves.  Every device-touching part of a pull and a warm-up
holds `repro_torch.serving.graph.DEVICE_LOCK`, as the engines and the
payload wrapper do around an Executable's ``fn`` and ``make_inputs``, so
the two threads never issue device work at once: a CUDA-graph capture on
one cannot be broken by an allocation on the other, and the launches each
makes stay its own.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import torch

from repro_torch.analysis.locks import make_lock
from repro_torch.configs.base import (
    ArchConfig, SHAPES, ShapeSpec, get_config, get_smoke_config)
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM, to_device
from repro_torch.launch.steps import (
    init_train_state, make_prefill_step, make_serve_step, make_train_step)
from repro_torch.models.api import build_model, resolve_device
from repro_torch.optim.adamw import OptimConfig
from repro_torch.serving.graph import DEVICE_LOCK


@dataclasses.dataclass(frozen=True)
class PayloadImage:
    """Immutable image reference (the `image:` field of the pod spec)."""
    arch: str                        # registry name, or "<name>-smoke"
    shape: str                       # key into SHAPES, or "smoke"
    mode: str                        # "train" | "prefill" | "decode" | "serve" | "noop"
    smoke: bool = True               # reduced config (tests/examples) vs full
    flags: tuple = ()                # e.g. (("attn_impl","pallas"), ("norm_impl","pallas"))
    # serve mode only: registry name of a DRAFT model for speculative
    # decoding.  Like the arch itself, the draft choice is a late-binding
    # decision — it names a different image (own cache key), and engines
    # from the image default to spec="draft" with this draft.
    draft: str | None = None
    # serve mode only: device-mesh shape ``(data, model)``; tensor-parallel
    # serving is ROADMAP.md Queue 1 item 8, so only None (one device) binds.
    mesh_shape: tuple | None = None
    # serve mode only: the engine's serving ROLE in a disaggregated fleet;
    # only "unified" binds until ROADMAP.md Queue 1 item 7.
    role: str = "unified"

    def key(self) -> tuple:
        return (self.arch, self.shape, self.mode, self.smoke, self.flags,
                self.draft, self.mesh_shape, self.role)

    def build_mesh(self):
        """The serve mesh this image requests: None (one device)."""
        if self.mesh_shape is None:
            return None
        raise NotImplementedError(
            f"mesh_shape={self.mesh_shape!r}: tensor-parallel serving is "
            f"ROADMAP.md Queue 1 item 8")

    def config(self) -> ArchConfig:
        cfg = get_smoke_config(self.arch) if self.smoke else get_config(self.arch)
        if self.flags:
            cfg = dataclasses.replace(cfg, **dict(self.flags))
        return cfg

    def shape_spec(self) -> ShapeSpec:
        if self.shape in SHAPES:
            return SHAPES[self.shape]
        if self.shape.startswith("custom:"):        # "custom:<seq>x<batch>"
            seq, batch = self.shape.split(":", 1)[1].split("x")
            return ShapeSpec(self.shape, int(seq), int(batch), self.mode)
        # smoke shapes: tiny, CPU-runnable
        mode = "train" if self.mode == "train" else self.mode
        return ShapeSpec("smoke", 64, 2, mode)


PLACEHOLDER = PayloadImage(arch="placeholder", shape="none", mode="noop")


@dataclasses.dataclass
class Executable:
    """A pulled image: built function + input builders, on ``device``."""
    image: PayloadImage
    fn: Any                           # step function or engine factory
    make_inputs: Any                  # (seed: int) -> concrete inputs
    compile_seconds: float            # the pull: bundle, kernels, first op
    cached: bool = False
    # stage first-use costs now (one representative invocation); prefetch()
    # runs this in the background so the whole pull overlaps the current
    # payload instead of landing on the next bind's first step.
    warm: Any = None
    device: torch.device | None = None


def sync(device: torch.device):
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernel_sources(cfg: ArchConfig) -> list[str]:
    """The kernel libraries (``csrc/<name>.cu``) an engine of ``cfg`` can
    launch: its ``*_impl`` flags select the hand-written kernels (MLA's
    decode paths are plain: only its prefill reaches a kernel, flash)."""
    names = []
    if cfg.attn_impl == "pallas" and not cfg.is_attention_free:
        names.append("flash_prefill")
        if cfg.mla is None:
            names += ["paged_decode", "paged_verify", "decode_attention"]
    if cfg.norm_impl == "pallas":
        names.append("rmsnorm")
    if cfg.moe_impl == "gmm" and cfg.moe is not None:
        names.append("grouped_matmul")
    if cfg.ssm_impl == "pallas" and cfg.ssm is not None:
        names.append("ssd_scan")
    return names


def _load_kernels(cfgs, device: torch.device):
    """Build (outside the lock: nvcc runs on the host) and load (under it)
    the kernel libraries of ``cfgs``.  The CPU runs the plain versions."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import _build
    names = sorted({n for cfg in cfgs for n in _kernel_sources(cfg)})
    _build.build(names)
    with DEVICE_LOCK:
        for n in names:
            _build.library(n)


class ExecutableRegistry:
    """Image cache keyed by (image, device).  Thread-safe; one build per
    key even under concurrent binds (single-flight)."""

    def __init__(self):
        self._lock = make_lock("images.registry")
        self._cache: dict[tuple, Executable] = {}
        self._inflight: dict[tuple, threading.Event] = {}
        self._prefetching: dict[tuple, threading.Event] = {}
        self.stats = {"hits": 0, "misses": 0, "prefetches": 0}

    @staticmethod
    def _device(device) -> torch.device:
        """The slice's device; None is the card (raises without one)."""
        return resolve_device("cuda" if device is None else device)

    @classmethod
    def _key(cls, image: PayloadImage, device) -> tuple:
        return (image.key(), cls._device(device))

    def prefetch(self, image: PayloadImage, device=None) -> threading.Event:
        """Start pulling an image in the BACKGROUND and return an event that
        is set once it is cached.  Single-flight with `pull`: a concurrent
        bind for the same key waits on the same build instead of starting
        a second one, and a later `pull` that lands mid-build parks on the
        inflight event and then takes the cache hit.

        This is how a pilot overlaps the next task's image pull with the
        current payload's run (the hint rides on the matched task) — the
        late-binding analogue of a kubelet pre-pulling the next image while
        the current container still executes.
        """
        key = self._key(image, device)
        with self._lock:
            ev = self._prefetching.get(key)
            if ev is not None:                # join the in-progress prefetch:
                return ev                     # set only after warm() finishes
            done = threading.Event()
            if key in self._cache:
                done.set()
                return done
            # claim the key under the lock so concurrent prefetches of the
            # same image join `done` instead of spawning a second worker
            self._prefetching[key] = done
            self.stats["prefetches"] += 1

        def work():
            try:
                # pull() joins any concurrent bind's build (single-flight)
                exe = self.pull(image, device)
                if exe.warm is not None:
                    exe.warm()            # stage the first-use costs too
            except Exception:             # noqa: BLE001 — prefetch is a hint
                pass
            finally:
                with self._lock:
                    self._prefetching.pop(key, None)
                done.set()

        threading.Thread(target=work, daemon=True,
                         name=f"prefetch-{image.arch}:{image.mode}").start()
        return done

    def pull(self, image: PayloadImage, device=None) -> Executable:
        key = self._key(image, device)
        while True:
            with self._lock:
                if key in self._cache:
                    self.stats["hits"] += 1
                    e = self._cache[key]
                    return Executable(e.image, e.fn, e.make_inputs,
                                      e.compile_seconds, cached=True,
                                      warm=e.warm, device=e.device)
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                    break
            ev.wait()                    # another bind is building this image
        try:
            exe = self._build(image, key[1])
            with self._lock:
                self._cache[key] = exe
                self.stats["misses"] += 1
            return exe
        finally:
            with self._lock:
                ev = self._inflight.pop(key)
            ev.set()

    # ------------------------------------------------------------------

    def _build(self, image: PayloadImage, dev: torch.device) -> Executable:
        t0 = time.monotonic()
        if image.mode == "noop":
            def fn(x):
                return x + 1.0

            def make_inputs(seed):
                return torch.zeros((), device=dev)

            with DEVICE_LOCK:
                fn(make_inputs(0))       # warm
            return Executable(image, fn, make_inputs, time.monotonic() - t0,
                              device=dev)
        cfg = image.config()
        shape = image.shape_spec()
        if image.mode == "train":
            fn, make_inputs, warm = _train_factory(cfg, shape, dev)
            return Executable(image, fn, make_inputs, time.monotonic() - t0,
                              warm=warm, device=dev)
        bundle = build_model(cfg)
        draft_cfg = None
        if image.mode == "serve" and image.draft:
            draft_cfg = (get_smoke_config(image.draft) if image.smoke
                         else get_config(image.draft))
        _load_kernels([c for c in (cfg, draft_cfg) if c is not None], dev)

        if image.mode == "prefill":
            fn = make_prefill_step(cfg)

            def make_inputs(seed):
                params = bundle.init(seed, device=dev)
                batch = _concrete_batch(cfg, shape, seed, dev)
                return params, batch

            def warm():
                with DEVICE_LOCK:
                    fn(*make_inputs(0))
                    sync(dev)
        elif image.mode == "serve":
            fn, make_inputs, warm = _serve_factory(image, cfg, shape, bundle,
                                                   draft_cfg, dev)
        else:                            # decode
            fn = make_serve_step(cfg)

            def make_inputs(seed):
                from repro_torch.models.api import init_decode_state
                params = bundle.init(seed, device=dev)
                state = init_decode_state(cfg, shape.global_batch,
                                          shape.seq_len, kv="dense",
                                          device=dev)
                return params, state

            def warm():
                with DEVICE_LOCK:
                    fn(*make_inputs(0))
                    sync(dev)

        return Executable(image, fn, make_inputs, time.monotonic() - t0,
                          warm=warm, device=dev)


def _train_factory(cfg, shape, dev):
    """A train image: the train step (``OptimConfig(total_steps=1000)``,
    as the reference's image), ``make_inputs(seed)`` -> (train state from
    ``seed``, the synthetic data of the image's shape) and a warm-up of one
    step on batch 0 with a throwaway state.  It loads no kernel: the step
    runs the plain paths, and flags that select a kernel raise here.

    Returns ``(fn, make_inputs, warm)``."""
    kernels = _kernel_sources(cfg)
    if kernels:
        raise NotImplementedError(
            f"{cfg.name}: a train image differentiates the plain paths, and "
            f"its flags select the {', '.join(kernels)} kernel(s), which are "
            "forward only: the JAX package defines no VJP for them")
    fn = make_train_step(cfg, OptimConfig(total_steps=1000))

    def make_inputs(seed):
        state = init_train_state(cfg, seed, dev)
        data = SyntheticLM(SyntheticConfig(cfg.vocab_size, shape.seq_len,
                                           shape.global_batch))
        return state, data

    def warm():
        with DEVICE_LOCK:
            state, data = make_inputs(0)
            fn(state, to_device(data.batch_at(0), dev))
            sync(dev)
            del state                    # freed before the lock is let go

    return fn, make_inputs, warm


def _serve_factory(image, cfg, shape, bundle, draft_cfg, dev):
    """A serve image is an ENGINE factory: the wrapper builds a
    continuous-batching ServeEngine over freshly initialized params and
    drives it from the request trace in the startup spec.  Every engine
    from this factory shares ONE step function per max_len, the bundle's
    prefill and chunk functions, and one draft model (weights from seed 0)
    — so a fleet's servers draft and replay bitwise alike; params come from
    the image's seed.  A captured CUDA graph replays one engine's own
    tensors, so each engine captures its own at construction.

    Returns ``(fn, make_inputs, warm)``."""
    from repro_torch.serving.engine import (
        ServeEngine, make_draft_step, make_engine_step, make_verify_step)

    step_fns: dict[int, Any] = {}
    spec_fns: dict[tuple, Any] = {}
    draft_bundle = build_model(draft_cfg) if draft_cfg is not None else None
    draft_params_cache: dict[str, Any] = {}

    def step_for(max_len):
        if max_len not in step_fns:
            step_fns[max_len] = make_engine_step(bundle, max_len)
        return step_fns[max_len]

    def spec_for(max_len, k):
        if (max_len, k) not in spec_fns:
            spec_fns[(max_len, k)] = (
                make_draft_step(draft_bundle or bundle, k, max_len),
                make_verify_step(bundle, max_len, k))
        return spec_fns[(max_len, k)]

    def draft_params_for():
        with DEVICE_LOCK:
            if "params" not in draft_params_cache:
                draft_params_cache["params"] = draft_bundle.init(0,
                                                                 device=dev)
        return draft_params_cache["params"]

    def fn(params, slots=None, max_len=None, mesh_shape=None, **kw):
        ml = max_len or shape.seq_len
        kw.setdefault("role", image.role)
        # a startup-spec mesh overrides the image's; any mesh raises in the
        # engine (tensor-parallel serving is a later slice)
        mesh = image.mesh_shape if mesh_shape is None else tuple(mesh_shape)
        if image.draft and kw["role"] == "unified":
            kw.setdefault("spec", "draft")
        if kw.get("spec") == "draft":
            kw.setdefault("spec_k", 4)
            dfn, vfn = spec_for(ml, int(kw["spec_k"]))
            kw.setdefault("draft_fn", dfn)
            kw.setdefault("verify_fn", vfn)
            if draft_bundle is not None:
                kw.setdefault("draft_cfg", draft_cfg)
                kw.setdefault("draft_bundle", draft_bundle)
                kw.setdefault("draft_params", draft_params_for())
                kw.setdefault("draft_prefill_fn", draft_bundle.prefill)
        return ServeEngine(cfg, params, slots=slots or shape.global_batch,
                           max_len=ml, bundle=bundle, step_fn=step_for(ml),
                           prefill_fn=bundle.prefill,
                           chunk_fn=bundle.prefill_chunk, mesh=mesh,
                           device=dev, **kw)

    def make_inputs(seed):
        return bundle.init(seed, device=dev)

    def warm():
        """Build a throwaway engine THROUGH the factory, so the staged
        shapes (KV layout, pool size, buckets) are those served engines
        use, and run its admission warm-up and one decode step (or one
        draft-and-verify step): kernel first launches, library handles and
        the allocator's blocks land before a live request.  Nothing of it
        outlives the call: the engine, its state and its params are its
        own.  Its step is eager — a graph is captured per engine, over that
        engine's tensors — and its admission one-shot: the port has no
        per-shape compile for a chunked warm-up to stage.  It holds the
        device lock throughout: a payload serving meanwhile waits for it
        once, at one tick (taking the lock piece by piece spread the wait
        over several ticks, with no gain in tokens/s)."""
        with DEVICE_LOCK:
            params = bundle.init(0, device=dev)
            eng = fn(params, step_graph=False)
            eng.warm_admission()
            if eng.spec == "draft":
                drafts, _ = eng._draft_fn(
                    eng.draft_params, eng._draft_cache, eng.state["token"],
                    eng.state["pos"], eng.state["block_tables"])
                eng._verify_fn(params, eng.state, eng.active, eng.budget,
                               drafts)
            else:
                eng._step_fn(params, eng.state, eng.active, eng.budget)
            sync(dev)
            del eng, params              # freed before the lock is let go

    return fn, make_inputs, warm


def _concrete_batch(cfg, shape, seed: int, device: torch.device) -> dict:
    """A prefill batch of ``shape``: token ids from a generator seeded with
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size,
                           (shape.global_batch, shape.seq_len),
                           generator=gen, device=device, dtype=torch.int32)
    return {"tokens": tokens}
