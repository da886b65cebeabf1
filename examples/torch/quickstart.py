"""Quickstart: the whole system in ~60 lines, on the port.

  PYTHONPATH=src python examples/torch/quickstart.py
  PYTHONPATH=src python examples/torch/quickstart.py --smoke --device cpu

Port of ``examples/quickstart.py``, the same steps and lines:

1. builds smollm-360m and takes a few training steps directly;
2. stands up the pilot system (cluster sim + task repo), submits train and
   serve payloads for TWO different models, and lets ONE pilot run them all
   on a single resource claim — container late-binding end to end.

On the card every model is at full width: training runs the plain paths
(the kernels are forward only), the decode payloads the hand-written
kernels (`repro_torch.launch.serve.KERNEL_FLAGS`: dense decode attention,
RMSNorm).  ``--smoke --device cpu`` runs the reference's smoke configs.
"""

import argparse
import time

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import PayloadImage
from repro_torch.core.pilot import PilotConfig
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM, to_device
from repro_torch.launch.serve import KERNEL_FLAGS
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.api import resolve_device
from repro_torch.optim.adamw import OptimConfig


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
    """Train directly, then run three payloads through one pilot; returns
    0.  ``record`` (a dict), when given, receives the direct losses and
    step seconds, the sim, the pilot and the images, for callers that
    check the run's gates."""
    args = parse_args(argv)
    dev = resolve_device(args.device)

    # ---- 1. direct training ------------------------------------------------

    cfg = (get_smoke_config if args.smoke else get_config)("smollm-360m")
    step = make_train_step(cfg, OptimConfig(total_steps=50))
    state = init_train_state(cfg, 0, dev)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, seq_len=128,
                                       global_batch=4, structure=0.9))
    print("== direct training ==")
    losses, step_s = [], []
    for i in range(10):
        t0 = time.monotonic()
        batch = to_device(data.batch_at(i), dev)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))     # waits for the step
        step_s.append(time.monotonic() - t0)
        if i % 3 == 0:
            print(f"  step {i}: loss {losses[-1]:.4f}")
    del state, metrics

    # ---- 2. the pilot system -----------------------------------------------

    print("== pilot system: one slice, three payloads, two models ==")
    sim = ClusterSim(device=dev)
    images = [PayloadImage("smollm-360m", "smoke", "train", smoke=args.smoke),
              PayloadImage("smollm-360m", "smoke", "decode", smoke=args.smoke,
                           flags=KERNEL_FLAGS),
              PayloadImage("gemma-2b", "smoke", "decode", smoke=args.smoke,
                           flags=KERNEL_FLAGS)]
    tasks = [sim.repo.submit(images[0], n_steps=3),
             sim.repo.submit(images[1], n_steps=4),
             sim.repo.submit(images[2], n_steps=4)]
    (slice_,) = sim.provision(1)
    pilot = sim.spawn_pilot(slice_, PilotConfig(max_payloads=4,
                                                idle_grace=1.0))
    assert sim.run_until_drained(timeout=300.0), "queue did not drain"
    sim.join_all(30.0)

    for h in pilot.history:
        img = h["image"]
        print(f"  payload {h['task_id']}: {img.arch}/{img.mode} "
              f"exit={h.get('exitcode')} bind={h['bind_seconds']*1e3:.1f}ms "
              f"cached={h['bind_cached']}")
    print(f"  repo: {sim.repo.stats()}")
    print("quickstart OK")
    if record is not None:
        record.update(losses=losses, step_s=step_s, sim=sim, pilot=pilot,
                      images=images, registry=sim.registry, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
