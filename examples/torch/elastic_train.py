"""Elastic scaling demo, on the port: the data-parallel mesh follows the
live-pilot set.

Two pilots drain a queue of training payloads; one is then drained
(graceful scale-down) and the launcher recomputes the mesh via
`plan_remesh` — the model axis is untouched, the data axis shrinks, and
training resumes from the checkpoint.

Port of ``examples/elastic_train.py``: the same steps, plans and lines.
On the card the train payloads are full-width smollm-360m on the plain
paths (the kernels are forward only), every pilot's slice the one card;
``--smoke --device cpu`` runs the reference's smoke config on the CPU.

  PYTHONPATH=src python examples/torch/elastic_train.py
  PYTHONPATH=src python examples/torch/elastic_train.py --smoke --device cpu
"""

import argparse

from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import PayloadImage
from repro_torch.core.pilot import PilotConfig
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
    """Scale down, drain, scale up; returns 0.  ``record`` (a dict), when
    given, receives the sim, the image, the task ids and the three plans,
    for callers that check the run's gates."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print("== elastic scale-down ==")
    sim = ClusterSim(device=dev)
    image = PayloadImage("smollm-360m", "smoke", "train", smoke=args.smoke)
    tids = [sim.repo.submit(image, n_steps=2) for _ in range(4)]

    fleet = sim.spawn_fleet(2, PilotConfig(max_payloads=6, idle_grace=2.0))
    plan0 = sim.remesh_plan(model_parallel=16, global_batch=256)
    print(f"  2 live pilots -> mesh {plan0.new_mesh.shape} "
          f"(per-slice batch {plan0.new_per_data})")

    (victim,) = fleet.scale_down(1)          # graceful drain, event-driven
    victim.join(60.0)
    plan1 = sim.remesh_plan(model_parallel=16, global_batch=256,
                            old=plan0.new_mesh)
    print(f"  after drain ({victim.state}) -> mesh {plan1.new_mesh.shape} "
          f"(per-slice batch {plan1.new_per_data}); actions: {plan1.actions}")

    assert fleet.await_drained(timeout=300.0)
    print(f"  queue drained by the remaining pilot: {sim.repo.stats()}")
    fleet.join_all(30.0)

    # grow back: three fresh slices join the fleet
    print("== elastic scale-up ==")
    fleet.scale_up(3)
    plan2 = sim.remesh_plan(model_parallel=16, global_batch=256,
                            old=plan1.new_mesh)
    print(f"  {fleet.size()} live pilots -> mesh {plan2.new_mesh.shape} "
          f"(per-slice batch {plan2.new_per_data}); actions: {plan2.actions}")
    fleet.join_all(30.0)
    print("elastic demo OK")
    if record is not None:
        record.update(sim=sim, images=[image], tids=tids,
                      registry=sim.registry, plans=[plan0, plan1, plan2],
                      device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
