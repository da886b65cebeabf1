"""Paper PoC #2 — the *fully dynamic* pod (paper §4), on the port: the
payload image is not known until the pilot fetches work from the task
repository, and one pilot serves several payloads (different models!)
over its lifetime.

Also demonstrates the fault-tolerance substrate: a second run injects a
node failure mid-payload and shows lease-expiry re-queue + checkpoint
resume on a replacement pilot.

Port of ``examples/dynamic_pilot.py``: the same steps and lines.  On the
card every model is at full width; the decode payloads (gemma-2b's dense
decode attention, RMSNorm in both; mamba2-370m's recurrent step is plain)
run on the hand-written kernels (`repro_torch.launch.serve.KERNEL_FLAGS`)
and the train payloads on the plain paths (the kernels are forward only).
On the card the failure half's train image runs at full width and 8 of
smollm-360m's 32 layers (``FAIL_LAYERS``): a full-depth checkpoint (f32
weights and two AdamW moments) is 4.35 GB, and at full depth the resumed
payload (190 steps and 19 checkpoints) would outlive the task's default
``max_wall`` of 120 s: the pilot's monitor would kill it and a retry
would resume from a later checkpoint.  ``main`` raises unless the resumed
payload exits 0 from the killed payload's last checkpoint.  The
checkpoints go to a temporary directory that is removed at the end.
``--smoke --device cpu`` runs the reference's smoke configs on the CPU.

  PYTHONPATH=src python examples/torch/dynamic_pilot.py
  PYTHONPATH=src python examples/torch/dynamic_pilot.py --smoke --device cpu
"""

import argparse
import shutil
import tempfile
import time

from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import PayloadImage
from repro_torch.core.pilot import PilotConfig
from repro_torch.core.taskrepo import TaskRepo
from repro_torch.launch.serve import KERNEL_FLAGS
from repro_torch.models.api import resolve_device

# the failure half's depth at full width (the smoke configs keep theirs)
FAIL_LAYERS = 8


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
    """Run both halves; returns 0.  ``record`` (a dict), when given,
    receives the first half's sim, pilot and images, the failure half's
    pilots, train image and checkpoint directory (gone by then), the
    checkpoint step the killed payload left and the resumed result, for
    callers that check the run's gates."""
    args = parse_args(argv)
    dev = resolve_device(args.device)

    def image(arch, mode, flags=()):
        return PayloadImage(arch, "smoke", mode, smoke=args.smoke,
                            flags=flags)

    print("== dynamic PoC (paper §4, second YAML): image fetched at runtime ==")
    sim = ClusterSim(device=dev)
    images = [image("smollm-360m", "train"),
              image("gemma-2b", "decode", KERNEL_FLAGS),
              image("mamba2-370m", "decode", KERNEL_FLAGS)]
    tasks = {
        "train smollm": sim.repo.submit(images[0], n_steps=3, priority=2),
        "serve gemma": sim.repo.submit(images[1], n_steps=4),
        "serve mamba2": sim.repo.submit(images[2], n_steps=4),
    }
    (s,) = sim.provision(1)
    pilot = sim.spawn_pilot(s, PilotConfig(max_payloads=5, idle_grace=1.0))
    assert sim.run_until_drained(timeout=300.0)
    sim.join_all(30.0)
    for h in pilot.history:
        print(f"  ran {h['image'].arch}/{h['image'].mode}: "
              f"exit={h.get('exitcode')} bind_cached={h['bind_cached']}")

    print("== failure injection: lease re-queue + checkpoint resume ==")
    repo = TaskRepo(lease_ttl=2.0)
    sim2 = ClusterSim(repo=repo, device=dev)
    ck = tempfile.mkdtemp(prefix="pilot_ck_")
    flags = () if args.smoke else (("num_layers", FAIL_LAYERS),)
    train = image("smollm-360m", "train", flags)
    try:
        tid = repo.submit(train, n_steps=200, max_attempts=5,
                          resume={"ckpt_dir": ck, "ckpt_every": 10})
        (s1,) = sim2.provision(1)
        p1 = sim2.spawn_pilot(s1, PilotConfig(max_payloads=2,
                                              idle_grace=0.5))
        # kill the node only once at least one checkpoint exists
        # (deterministic demo)
        deadline = time.monotonic() + 240
        while ckpt_mod.latest_step(ck) is None and time.monotonic() < deadline:
            time.sleep(0.25)
        sim2.fail_node(s1.slice_id)
        p1.join(30.0)
        # the node's payload dies with it: its thread stops at its next
        # step, so no checkpoint of it lands after the replacement binds
        p1.executor.join(60.0)
        killed_at = ckpt_mod.latest_step(ck)
        print(f"  pilot 1 ({p1.pilot_id}): state={p1.state} (hard node loss)")

        (s2,) = sim2.provision(1)
        p2 = sim2.spawn_pilot(s2, PilotConfig(max_payloads=2,
                                              idle_grace=3.0))
        assert sim2.run_until_drained(timeout=300.0)
        sim2.join_all(30.0)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    res = repo.result(tid)
    print(f"  pilot 2 ({res.pilot_id}): exit={res.exitcode} "
          f"resumed_from={res.telemetry.get('resumed_from')} "
          f"steps_run={res.telemetry.get('steps')}")
    if res.exitcode != 0 or res.telemetry.get("resumed_from") != killed_at:
        raise RuntimeError(
            f"the resumed payload exited {res.exitcode} from step "
            f"{res.telemetry.get('resumed_from')}, not from the killed "
            f"payload's last checkpoint ({killed_at})")
    print("dynamic PoC OK")
    if record is not None:
        record.update(sim=sim, pilot=pilot, images=images,
                      registry=sim.registry, device=dev, p1=p1, p2=p2,
                      train=train, ckpt_dir=ck, killed_at=killed_at,
                      result=res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
