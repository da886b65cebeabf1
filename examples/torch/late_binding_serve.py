"""Serving through late binding: one pilot-held slice serves BATCHED
requests for two different models back-to-back — the image swap replaces a
full re-provision between models.

Port of ``examples/late_binding_serve.py``: the same steps and lines.  On
the card each model runs at full width on the hand-written kernels
(`repro_torch.launch.serve.KERNEL_FLAGS`: flash admissions, paged decode,
RMSNorm), its engine's decode step a captured CUDA graph; ``--smoke
--device cpu`` runs the reference's smoke configs on the CPU.  The next
image's prefetch builds and warms it on another thread while the current
engine serves; both sides do their device work under
`repro_torch.serving.graph.DEVICE_LOCK` (the engine and the registry take
it themselves, and the weights below are made under it).

  PYTHONPATH=src python examples/torch/late_binding_serve.py
  PYTHONPATH=src python examples/torch/late_binding_serve.py --smoke \\
      --device cpu
"""

import argparse
import time

import torch

from repro_torch.core.arena import SharedArena
from repro_torch.core.images import ExecutableRegistry, PayloadImage
from repro_torch.core.latebind import PayloadExecutor, PodPatchCapability
from repro_torch.core.proctable import ProcessTable
from repro_torch.launch.serve import KERNEL_FLAGS
from repro_torch.models.api import build_model, resolve_device
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.graph import DEVICE_LOCK

ARCHS = ("smollm-360m", "gemma-2b")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the card (the default; raises without one), or "
                         "'cpu' with --smoke")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's smoke configs (full width "
                         "otherwise)")
    return ap.parse_args(argv)


def main(argv=None, record=None):
    """Serve both models in turn; returns 0.  ``record`` (a dict), when
    given, receives the registry, the images, each model's bind and its
    engine's stats and leaked blocks, for callers that check the run's
    gates."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print("== batched serving via late binding ==")

    arena = SharedArena()
    registry = ExecutableRegistry()
    executor = PayloadExecutor("pod-serve", arena, ProcessTable(), registry,
                               device=dev)
    cap = PodPatchCapability("pod-serve")

    # the prompts' draws: a seeded generator, one stream for both models
    gen = torch.Generator().manual_seed(0)
    images = [PayloadImage(a, "smoke", "decode", smoke=args.smoke,
                           flags=KERNEL_FLAGS) for a in ARCHS]
    runs = []
    for n, arch in enumerate(ARCHS):
        t0 = time.monotonic()
        image = images[n]
        executor.patch_image(cap, image)         # the unprivileged image swap
        bind_ms = (time.monotonic() - t0) * 1e3
        cached = executor.last_bind_cached
        if n + 1 < len(ARCHS):                   # overlap the NEXT image's pull
            registry.prefetch(images[n + 1], dev)

        cfg = image.config()
        with DEVICE_LOCK:                        # the prefetch warms meanwhile
            params = build_model(cfg).init(0, device=dev)
        engine = ServeEngine(cfg, params, slots=2, max_len=64, device=dev)
        for i in range(4):
            engine.submit(Request(
                rid=i, prompt=torch.randint(0, cfg.vocab_size, (8,),
                                            generator=gen,
                                            dtype=torch.int32).numpy(),
                max_new_tokens=6))
        stats = engine.run()
        print(f"  {arch}: bind {bind_ms:.1f} ms -> {stats['completed']} "
              f"requests, {stats['tok_per_s']:.1f} tok/s, "
              f"util {stats['slot_utilization']:.2f}")
        runs.append({"arch": arch, "bind_ms": bind_ms, "bind_cached": cached,
                     "stats": stats, "block_leaks": engine.block_leaks(),
                     "tokens": {r.rid: list(r.tokens)
                                for r in engine.done.values()}})
        with DEVICE_LOCK:                        # its graph and pools go
            del engine, params                   # under the lock too
        executor.reset()                         # cleanup between models (§3.6)
        arena.wipe_shared()

    arena.destroy()
    print("late-binding serve OK")
    if record is not None:
        record.update(registry=registry, images=images, device=dev,
                      runs=runs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
