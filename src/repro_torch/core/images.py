"""PayloadImage + ExecutableRegistry — container images and the image cache.

Port of ``repro.core.images``.  A *PayloadImage* names everything needed to
build the payload's executable: (architecture x input shape x step kind x
flags).  "Pulling" an image builds the model bundle and builds and loads
the kernel libraries its flags select (``kernels/_build.py``: nvcc at first
use, cached on disk under ``build/kernels/``); the registry's cache plays
the node's local image cache — a warm ``bind()`` skips the pull exactly as
a cached image does.  The reference keys its cache on the slice's mesh;
here the key holds the slice's device, or its mesh when the slice holds
one (a `repro_torch.runtime.mesh.DeviceMesh`): a serve image of a
``mesh_shape`` builds its engines on that shape over the slice's mesh
devices, so a pilot late-binds a tensor-parallel image onto a slice it
already holds, for every decoder arch and in every role.

An encoder-decoder (whisper) runs through its "prefill" image (frames and
a prompt) and its "decode" image (a dense decode state); its "serve"
image's engine refuses it, and its "train" image fails on the batch's
missing ``frontend``, as the reference's do.

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
from repro_torch.models.api import (
    _has_frontend, _text_len, build_model, resolve_device)
from repro_torch.optim.adamw import OptimConfig
from repro_torch.runtime.mesh import DeviceMesh
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
    # serve mode only: device-mesh shape ``(data, model)`` the image's
    # engines run on (None = one device).  Mesh shape is a late-binding
    # decision exactly like the arch: a pilot claims devices first, and the
    # mesh-shaped image binds after, so it is part of ``key()``.
    mesh_shape: tuple | None = None
    # serve mode only: the engine's serving ROLE in a disaggregated fleet
    # ("unified" | "prefill" | "decode").  A bind-time decision exactly
    # like the arch: a pilot claims a slice first and the role comes with
    # the image it binds, which stages only that role's half.
    role: str = "unified"

    def key(self) -> tuple:
        return (self.arch, self.shape, self.mode, self.smoke, self.flags,
                self.draft, self.mesh_shape, self.role)

    def build_mesh(self, devices=None):
        """The serve mesh this image requests over ``devices`` (one per
        rank; None: ``cuda:0..N-1``), or None (one device)."""
        if self.mesh_shape is None:
            return None
        from repro_torch.runtime.mesh import serve_mesh
        return serve_mesh(self.mesh_shape, devices)

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


def _kernel_sources(cfg: ArchConfig, role: str = "unified") -> list[str]:
    """The kernel libraries (``csrc/<name>.cu``) an engine or a bundle of
    ``cfg`` in serving ``role`` can launch: its ``*_impl`` flags select the
    hand-written kernels (MLA's decode paths are plain: only its prefill
    reaches a kernel, flash; an encoder-decoder runs flash and the dense
    decode kernel; LayerNorm archs reach no RMSNorm kernel).  A prefill
    role runs admissions only (flash, the grouped matmul); a decode role
    runs the paged decode step only (spec is off, the layout paged)."""
    names = []
    if cfg.attn_impl == "pallas" and not cfg.is_attention_free:
        if role != "decode":
            names.append("flash_prefill")
        if cfg.is_encdec:
            names.append("decode_attention")
        elif cfg.mla is None and role == "decode":
            names.append("paged_decode")
        elif cfg.mla is None and role == "unified":
            names += ["paged_decode", "paged_verify", "decode_attention"]
    if cfg.norm_impl == "pallas" and cfg.norm == "rmsnorm":
        names.append("rmsnorm")
    if cfg.moe_impl == "gmm" and cfg.moe is not None and role != "decode":
        names.append("grouped_matmul")
    if cfg.ssm_impl == "pallas" and cfg.ssm is not None:
        names.append("ssd_scan")
    return names


def _load_kernels(cfgs, device: torch.device, role: str = "unified"):
    """Build (outside the lock: nvcc runs on the host) and load (under it)
    the kernel libraries of ``cfgs`` in serving ``role``.  The CPU runs the
    plain versions."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import _build
    names = sorted({n for cfg in cfgs for n in _kernel_sources(cfg, role)})
    _build.build(names)
    with DEVICE_LOCK:
        for n in names:
            _build.library(n)


class ExecutableRegistry:
    """Image cache keyed by (image, device) or (image, mesh).  Thread-safe;
    one build per key even under concurrent binds (single-flight).  The
    second argument of `pull` and `prefetch` is where the slice runs: its
    device (None is the card) or its `repro_torch.runtime.mesh.DeviceMesh`
    (the reference passes the slice's mesh there)."""

    def __init__(self):
        self._lock = make_lock("images.registry")
        self._cache: dict[tuple, Executable] = {}
        self._inflight: dict[tuple, threading.Event] = {}
        self._prefetching: dict[tuple, threading.Event] = {}
        self.stats = {"hits": 0, "misses": 0, "prefetches": 0}

    @staticmethod
    def _device(where) -> torch.device:
        """The slice's device (a mesh's lead); None is the card (raises
        without one)."""
        if isinstance(where, DeviceMesh):
            return where.lead
        return resolve_device("cuda" if where is None else where)

    @classmethod
    def _key(cls, image: PayloadImage, where) -> tuple:
        mesh = where.key() if isinstance(where, DeviceMesh) else None
        return (image.key(), cls._device(where), mesh)

    def prefetch(self, image: PayloadImage, where=None) -> threading.Event:
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
        key = self._key(image, where)
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
                exe = self.pull(image, where)
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

    def pull(self, image: PayloadImage, where=None) -> Executable:
        key = self._key(image, where)
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
            exe = self._build(image, key[1], where if key[2] else None)
            with self._lock:
                self._cache[key] = exe
                self.stats["misses"] += 1
            return exe
        finally:
            with self._lock:
                ev = self._inflight.pop(key)
            ev.set()

    # ------------------------------------------------------------------

    def _build(self, image: PayloadImage, dev: torch.device,
               mesh=None) -> Executable:
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
        _load_kernels([c for c in (cfg, draft_cfg) if c is not None], dev,
                      image.role)

        if image.mode == "prefill":
            # eager: its payload makes one call, which a capture would
            # cost more than (`make_prefill_step`)
            fn = make_prefill_step(cfg)

            def make_inputs(seed):
                params = bundle.init(seed, device=dev)
                batch = _concrete_batch(cfg, shape, seed, dev)
                return params, batch

            def warm():
                with DEVICE_LOCK:
                    warm_step(*make_inputs(0))
                    sync(dev)
        elif image.mode == "serve":
            fn, make_inputs, warm = _serve_factory(image, cfg, shape, bundle,
                                                   draft_cfg, dev, mesh)
        else:                            # decode
            # on the card each payload's state captures its own graph of
            # the step at its first call (`make_serve_step`); the warm-up
            # below runs the step eagerly on a throwaway state, as a serve
            # image's does: it stages the kernel builds and library
            # handles, and a graph of that state would replay nothing the
            # payload's state can use
            fn = make_serve_step(cfg)
            warm_step = make_serve_step(cfg, step_graph=False)

            def make_inputs(seed):
                from repro_torch.models.api import init_decode_state
                params = bundle.init(seed, device=dev)
                state = init_decode_state(cfg, shape.global_batch,
                                          shape.seq_len, kv="dense",
                                          device=dev)
                return params, state

            def warm():
                with DEVICE_LOCK:
                    warm_step(*make_inputs(0))
                    sync(dev)

        return Executable(image, fn, make_inputs, time.monotonic() - t0,
                          warm=warm, device=dev)


def _train_factory(cfg, shape, dev):
    """A train image: the train step (``OptimConfig(total_steps=1000)``,
    as the reference's image), ``make_inputs(seed)`` -> (train state from
    ``seed``, the synthetic data of the image's shape) and a warm-up of one
    step on batch 0 with a throwaway state.  It loads no kernel: the step
    runs the plain paths, and flags that select a kernel raise here.  On
    the card each payload's state captures its own CUDA graph of the step
    at its first call (`make_train_step`, the graph kept in the state); the
    warm-up runs the step eagerly, as a decode image's does: a graph of the
    throwaway state would replay nothing a payload's state can use.

    Returns ``(fn, make_inputs, warm)``."""
    kernels = _kernel_sources(cfg)
    if kernels:
        raise NotImplementedError(
            f"{cfg.name}: a train image differentiates the plain paths, and "
            f"its flags select the {', '.join(kernels)} kernel(s), which are "
            "forward only: the JAX package defines no VJP for them")
    fn = make_train_step(cfg, OptimConfig(total_steps=1000))
    warm_step = make_train_step(cfg, OptimConfig(total_steps=1000),
                                step_graph=False)

    def make_inputs(seed):
        state = init_train_state(cfg, seed, dev)
        data = SyntheticLM(SyntheticConfig(
            cfg.vocab_size, _text_len(cfg, shape.seq_len), shape.global_batch))
        return state, data

    def warm():
        with DEVICE_LOCK:
            state, data = make_inputs(0)
            warm_step(state, to_device(data.batch_at(0), dev))
            sync(dev)
            del state                    # freed before the lock is let go

    return fn, make_inputs, warm


def _serve_factory(image, cfg, shape, bundle, draft_cfg, dev,
                   slice_mesh=None):
    """A serve image is an ENGINE factory: the wrapper builds a
    continuous-batching ServeEngine over freshly initialized params and
    drives it from the request trace in the startup spec.  Every engine
    from this factory shares ONE step function per max_len, the bundle's
    prefill and chunk functions, and one draft model (weights from seed 0)
    — so a fleet's servers draft and replay bitwise alike; params come from
    the image's seed.  A captured CUDA graph replays one engine's own
    tensors, so each engine captures its own (`ServeEngine`'s
    ``step_graph``).  The image's role picks the half it stages: a prefill
    image wires no step function (its engines capture their admission
    graphs only), a decode image no prefill or chunk function (its engines
    admit through the import scatter and capture their decode step).  An image
    with a ``mesh_shape`` (or a startup spec's ``mesh_shape``, which
    overrides it) builds each engine on that mesh over the slice's mesh
    devices (``slice_mesh``; without one, ``cuda:0..N-1``).

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

    mesh_devices = (None if slice_mesh is None
                    else list(slice_mesh.devices.flat))

    def fn(params, slots=None, max_len=None, mesh_shape=None, **kw):
        ml = max_len or shape.seq_len
        kw.setdefault("role", image.role)
        # a startup-spec mesh overrides the image's
        img = (image if mesh_shape is None else
               dataclasses.replace(image, mesh_shape=tuple(mesh_shape)))
        mesh = img.build_mesh(mesh_devices)
        role = kw["role"]
        if image.draft and role == "unified":
            # a split role forces spec off (draft KV does not ride the
            # handoff): it gets no draft functions to drop
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
                           max_len=ml, bundle=bundle,
                           step_fn=step_for(ml) if role != "prefill" else None,
                           prefill_fn=(bundle.prefill if role != "decode"
                                       else None),
                           chunk_fn=(bundle.prefill_chunk if role != "decode"
                                     else None),
                           mesh=mesh, device=dev, **kw)

    def make_inputs(seed):
        return bundle.init(seed, device=dev)

    def warm():
        """Build a throwaway engine THROUGH the factory, so the staged
        shapes (KV layout, pool size, buckets) are those served engines
        use, and run its admission warm-up and one decode step (or one
        draft-and-verify step): kernel first launches, library handles and
        the allocator's blocks land before a live request.  Nothing of it
        outlives the call: the engine, its state and its params are its
        own.  It runs eagerly (``step_graph=False``), as a decode image's
        warm-up does: a graph replays one engine's tensors, so the
        throwaway engine's captures would stage nothing the bound engine
        could replay (it captures its own, its decode step and spec pair at
        construction, its admission buckets and chunk shapes at first use
        or in `ServeEngine.warm_admission`), and a capture would
        synchronize the device and empty the allocator's cache while
        another payload may be serving.
        Its admission is one-shot.  It holds the
        device lock throughout: a payload serving meanwhile waits for it
        once, at one tick (taking the lock piece by piece spread the wait
        over several ticks, with no gain in tokens/s).  A prefill image's
        engine warms its admissions only; a decode image's warms no
        prefill but runs its dummy handoffs through the import scatter
        and the decode step (`ServeEngine.warm_install`)."""
        with DEVICE_LOCK:
            params = bundle.init(0, device=dev)
            eng = fn(params, step_graph=False)
            eng.warm_admission()                 # no-op for a decode role
            if eng.role == "decode":
                eng.warm_install()
            elif eng.spec == "draft":
                drafts, _ = eng._draft_fn(
                    eng.draft_params, eng._draft_cache, eng.state["token"],
                    eng.state["pos"], eng.state["block_tables"])
                eng._verify_fn(params, eng.state, eng.active, eng.budget,
                               drafts)
            elif eng.role == "unified":          # a prefill role never steps
                eng._step_fn(params, eng.state, eng.active, eng.budget)
            sync(dev)
            del eng, params              # freed before the lock is let go

    return fn, make_inputs, warm


def _concrete_batch(cfg, shape, seed: int, device: torch.device) -> dict:
    """A prefill batch of ``shape``: token ids (the text length: a VLM's
    patches take part of the sequence) from a generator seeded with
    ``seed`` on ``device``, and for the VLM and audio families the
    frontend's stub embeddings, normal x 0.02 in bf16, as the reference's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    B = shape.global_batch
    tokens = torch.randint(0, cfg.vocab_size,
                           (B, _text_len(cfg, shape.seq_len)),
                           generator=gen, device=device, dtype=torch.int32)
    batch = {"tokens": tokens}
    if _has_frontend(cfg):
        batch["frontend"] = torch.randn(
            (B, cfg.frontend_tokens, cfg.d_model), generator=gen,
            device=device).to(torch.bfloat16) * 0.02
    return batch
