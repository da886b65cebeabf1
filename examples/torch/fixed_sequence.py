"""Paper PoC #1 — the *fixed sequence* pod (paper §4), on the port.

The paper's first proof-of-concept YAML runs a pre-scripted sequence:
a pilot container and a payload container sharing a volume; the payload
waits for a startup script; the pilot writes it; the payload runs and
reports its exit code through the shared volume.  No scheduler, no
matchmaking — just the enabling mechanisms, in order.

Port of ``examples/fixed_sequence.py``: the same steps and lines.  The
payload image is a decode image of smollm-360m on the hand-written
kernels (`repro_torch.launch.serve.KERNEL_FLAGS`) at full width on the
card; ``--smoke --device cpu`` runs the reference's smoke config on the
CPU, where every kernel wrapper runs its plain version.

  PYTHONPATH=src python examples/torch/fixed_sequence.py
  PYTHONPATH=src python examples/torch/fixed_sequence.py --smoke --device cpu
"""

import argparse

from repro_torch.core.arena import SharedArena
from repro_torch.core.images import ExecutableRegistry, PayloadImage
from repro_torch.core.latebind import PayloadExecutor, PodPatchCapability
from repro_torch.core.proctable import PAYLOAD_UID, PILOT_UID, ProcessTable
from repro_torch.launch.serve import KERNEL_FLAGS
from repro_torch.models.api import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the card (the default; raises without one), or "
                         "'cpu' with --smoke")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's smoke config (full width "
                         "otherwise)")
    return ap.parse_args(argv)


def main(argv=None, record=None):
    """Run the PoC; returns 0.  ``record`` (a dict), when given, receives
    the registry, the image, the bind and the payload's exit record, for
    callers that check the run's gates."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print("== fixed-sequence PoC (paper §4, first YAML) ==")

    # Pod creation: shared volume + both containers; payload holds the
    # placeholder image and blocks on the startup-script path.
    arena = SharedArena()
    proctable = ProcessTable()
    registry = ExecutableRegistry()
    executor = PayloadExecutor("pod-poc", arena, proctable, registry,
                               device=dev)
    print(f"1. pod created; payload container image = "
          f"{executor.image.arch!r} (placeholder), state = {executor.state}")

    # The fixed sequence: the pilot already knows which image it will run.
    cap = PodPatchCapability("pod-poc")
    image = PayloadImage("smollm-360m", "smoke", "decode", smoke=args.smoke,
                         flags=KERNEL_FLAGS)
    executor.patch_image(cap, image)
    print(f"2. pod patch: payload image -> {image.arch}/{image.mode} "
          f"(bind {executor.last_bind_seconds*1e3:.1f} ms, unprivileged)")
    bind = (executor.last_bind_seconds, executor.last_bind_cached)

    executor.start(spec_timeout=10.0)
    print("3. payload container started; waiting on startup script ...")

    arena.write_env({"seed": 0, "greeting": "from-the-pilot"})
    arena.publish_startup_spec({"n_steps": 3})
    print("4. pilot wrote env + startup script into the shared volume")

    executor.join(timeout=120.0)
    exit_info = arena.read_exit()
    print(f"5. payload finished: exit={exit_info['exitcode']} "
          f"steps={exit_info['telemetry']['steps']} "
          f"(relayed via exitcode.json, §3.5)")

    # §3.4: the pilot saw the payload's 'process' the whole time
    entries = proctable.entries(uid=PAYLOAD_UID, viewer_uid=PILOT_UID)
    print(f"6. process table (pilot view): "
          f"{[(e.name, e.state, e.exitcode) for e in entries]}")

    executor.reset()
    arena.wipe_shared()
    print(f"7. cleanup by container restart; shared volume now: "
          f"{arena.shared_files()}")
    arena.destroy()
    executor.close()          # the pod's container-runtime thread ends too
    print("fixed-sequence PoC OK")
    if record is not None:
        record.update(registry=registry, images=[image], device=dev,
                      bind=bind, exit=exit_info)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
