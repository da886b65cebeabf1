"""Serve entry point of the port: a request trace answered by one engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --requests 16 --slots 8 --max-len 1024 [--spec draft] [--kv dense] \
        [--prefill chunked --prefill-chunk 128] [--eager] [--wave]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --via-pilots \\
        --archs smollm-360m,mamba2-370m [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \\
        --mesh 1x2 [--mesh-devices cuda:0,cuda:0] [--smoke --device cpu]

Port of ``make_trace`` and ``serve_direct`` from ``repro.launch.serve``.
The serve entry point builds the main path with the hand-written kernels
(``attn_impl="pallas"``, ``norm_impl="pallas"``, ``moe_impl="gmm"`` for
an MoE arch such as granite-moe-3b-a800m, ``ssm_impl="pallas"`` for a
Mamba-2 arch such as mamba2-370m) on ``device`` ("cuda" by default;
without a card it raises unless the caller asks for "cpu"): a paged or
dense KV cache, with or without draft-and-verify speculation.  An
attention-free arch, and a sliding-window one such as mixtral-8x7b (its
rolling rings), serve on the dense layout with speculation off, as the
reference's engine chooses.  ``mesh_shape`` (``--mesh AxB``) serves
tensor-parallel over a ``(data, model)`` mesh (`serve_mesh_for`): params
and KV pools split over the model ranks, streams bitwise the single-device
engine's.
Admission is one-shot or chunked (``prefill="chunked"``), continuous or in
waves (``admission="wave"``, ``--wave``: the baseline); on the card an
engine replays CUDA graphs of what the reference compiles: its decode
step or spec pair, its admission prefill per bucket and its chunk
function per chunk length (``step_graph=False``, ``--eager``: all
eager).

``--via-pilots`` (`serve_via_pilots`, port of the reference's) submits
each arch of ``--archs`` as a ``serve`` payload image and lets ONE pilot,
holding one slice of ``device``, late-bind them in turn: each engine run,
trace and all, is a payload; task i carries a prefetch hint for task
i+1's image, so the next image's pull and warm-up overlap the current
server's run.

    PYTHONPATH=src python -m repro_torch.launch.serve --pilots 3 \
        [--fail-at 4] [--draft self] [--chaos] [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --autoscale \
        [--pilots 3] [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --disagg \
        [--prefill-pilots 2 --decode-pilots 2] [--fail-prefill-at 2] \
        [--fail-decode-at 4] [--arch minicpm3-4b] [--smoke --device cpu]

``--pilots N`` (`serve_fleet`) is fleet serve: N pilots each late-bind the
same serve image and lease requests from one
:class:`~repro_torch.serving.dispatch.FleetDispatcher` pool; ``--fail-at
K`` kills the pilot holding the most leases once K requests have settled,
and its in-flight requests requeue onto the survivors.  ``--autoscale``
(`serve_fleet_schedule`) drives a fleet through a bursty wall-clock
schedule under the demand-driven
:class:`~repro_torch.core.autoscaler.FleetAutoscaler`, which grows it and
shrinks it to zero in the gaps.  Every slice of a ``ClusterSim`` holds
every card of the host, so on one card the fleet is N engines on that
card, each on its pilot's thread, taking turns at
`repro_torch.serving.graph.DEVICE_LOCK`.

``--disagg`` (`serve_disagg`) splits the fleet by role: prompts lease into
a pool of prefill-role servers, each finished prefill exports a KV block
handoff that becomes a lease in a pool of decode-role servers (the
:class:`~repro_torch.serving.dispatch.DisaggRouter`), and
``--fail-prefill-at`` / ``--fail-decode-at`` kill one pilot of a stage.
`serve_disagg_schedule` runs the two pools under two autoscalers, each
reading its own pool's slice of the pressure.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import PayloadImage
from repro_torch.core.pilot import PilotConfig
from repro_torch.models.api import build_model, resolve_device
from repro_torch.runtime.mesh import (
    parse_mesh_shape, serve_mesh, serve_mesh_spec)
from repro_torch.serving.dispatch import FleetDispatcher
from repro_torch.serving.engine import ServeEngine, admit_length


def make_trace(vocab_size: int, n_requests: int, *, max_len: int = 128,
               seed: int = 0, dup_rate: float = 0.0,
               prompt_len: tuple[int, int] | None = None,
               max_new_tokens: int | None = None) -> list[dict]:
    """Staggered-arrival request trace (the startup-spec format): request i
    becomes visible at engine tick ``i``.  With the defaults it
    is the reference's trace, draw for draw: prompt lengths in
    ``[4, max_len // 4)`` and budgets from {6, 10, 18, 28}.
    ``prompt_len=(lo, hi)`` draws lengths in ``[lo, hi]`` instead and
    ``max_new_tokens`` fixes every budget.  ``dup_rate`` is the fraction of
    requests that repeat an earlier prompt verbatim."""
    rng = np.random.default_rng(seed)
    trace = []
    for i in range(n_requests):
        if trace and rng.random() < dup_rate:
            prompt = list(trace[int(rng.integers(0, len(trace)))]["prompt"])
        else:
            if prompt_len is None:
                plen = int(rng.integers(4, max(5, max_len // 4)))
            else:
                plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
            prompt = rng.integers(0, vocab_size, size=plen).tolist()
        budget = int(rng.choice([6, 10, 18, 28]))
        trace.append({
            "rid": i,
            "prompt": prompt,
            "max_new_tokens": budget if max_new_tokens is None
            else int(max_new_tokens),
            "at_step": i,
        })
    return trace


def expected_tokens(entry: dict, max_len: int) -> int:
    """Tokens a request of the trace finishes with: the admission token
    plus one per decode step until its budget is spent or its slot
    reaches ``max_len``."""
    plen = admit_length(len(entry["prompt"]), max_len)
    return 1 + min(int(entry["max_new_tokens"]), max_len - plen)


KERNEL_FLAGS = (("attn_impl", "pallas"), ("norm_impl", "pallas"),
                ("moe_impl", "gmm"), ("ssm_impl", "pallas"))


def _on_kernels(cfg):
    return dataclasses.replace(cfg, **dict(KERNEL_FLAGS))


def build_engine(cfg, slots: int, max_len: int, seed: int = 0,
                 num_blocks: int | None = None, block_size: int = 16,
                 kv: str | None = None, spec: str = "off", spec_k: int = 4,
                 draft_cfg=None, draft_seed: int = 0,
                 prefill: str = "oneshot", prefill_chunk: int = 32,
                 step_graph: bool | None = None, prefix_sharing: bool = True,
                 admission: str = "continuous", role: str = "unified",
                 device="cuda", mesh=None) -> ServeEngine:
    """The serve entry point's engine: ``cfg`` on the hand-written kernels,
    weights from ``seed``, a paged pool of ``num_blocks`` blocks (or a
    dense cache with ``kv="dense"``).  ``spec="draft"`` proposes
    ``spec_k`` tokens a step from ``draft_cfg`` with weights from
    ``draft_seed`` (``draft_cfg=None``: the target drafts for itself).
    ``prefill``, ``prefill_chunk``, ``step_graph``, ``prefix_sharing``,
    ``admission`` and ``role`` go to the engine.  ``mesh`` (a
    `repro_torch.runtime.mesh.DeviceMesh`, see `serve_mesh_for`) shards
    the engine over its ranks; the weights are made on its lead device."""
    dev = mesh.lead if mesh is not None else resolve_device(device)
    cfg = _on_kernels(cfg)
    bundle = build_model(cfg)
    params = bundle.init(seed, device=dev)
    draft_params = None
    if draft_cfg is not None:
        draft_cfg = _on_kernels(draft_cfg)
        draft_params = build_model(draft_cfg).init(draft_seed, device=dev)
    return ServeEngine(cfg, params, slots=slots, max_len=max_len, kv=kv,
                       block_size=block_size, num_blocks=num_blocks,
                       bundle=bundle, spec=spec, spec_k=spec_k,
                       draft_cfg=draft_cfg, draft_params=draft_params,
                       prefill=prefill, prefill_chunk=prefill_chunk,
                       step_graph=step_graph, prefix_sharing=prefix_sharing,
                       admission=admission, role=role, device=dev, mesh=mesh)


def serve_mesh_for(mesh_shape, mesh_devices=None, device="cuda"):
    """The serve mesh of ``mesh_shape`` (``"AxB"`` or a tuple; None: no
    mesh) over ``mesh_devices``.  Without devices, a CPU entry point puts
    every rank on the CPU (the caller asked for it), and a card entry
    point takes ``cuda:0..N-1`` (`serve_mesh` raises on fewer cards; two
    ranks on one card are asked for as ``("cuda:0", "cuda:0")``)."""
    if mesh_shape is None:
        return None
    spec = serve_mesh_spec(mesh_shape)
    if mesh_devices is None and resolve_device(device).type == "cpu":
        mesh_devices = ["cpu"] * spec.num_devices
    return serve_mesh(spec.shape, mesh_devices)


def serve_direct(cfg, n_requests: int, slots: int, max_len: int,
                 seed: int = 0, num_blocks: int | None = None,
                 block_size: int = 16, dup_rate: float = 0.0,
                 prompt_len: tuple[int, int] | None = None,
                 max_new_tokens: int | None = None, kv: str | None = None,
                 spec: str = "off", spec_k: int = 4, draft_cfg=None,
                 draft_seed: int = 0, prefill: str = "oneshot",
                 prefill_chunk: int = 32, step_graph: bool | None = None,
                 prefix_sharing: bool = True, admission: str = "continuous",
                 device="cuda", trace: list[dict] | None = None,
                 mesh_shape=None, mesh_devices=None) -> dict:
    """Build the model from ``seed`` and an engine over it
    (`build_engine`), answer ``trace`` (default: a ``make_trace`` trace of
    ``n_requests``), and return the engine's stats plus ``streams`` ({rid:
    tokens}), ``tokens_per_request`` ({rid: count}) and ``block_leaks``;
    on a card also ``run_peak_bytes``, the most device memory the run
    allocated above what the built engine held (it resets the device's
    peak-memory counter).  ``mesh_shape`` serves tensor-parallel over
    `serve_mesh_for`'s mesh."""
    eng = build_engine(cfg, slots, max_len, seed=seed, num_blocks=num_blocks,
                       block_size=block_size, kv=kv, spec=spec,
                       spec_k=spec_k, draft_cfg=draft_cfg,
                       draft_seed=draft_seed, prefill=prefill,
                       prefill_chunk=prefill_chunk, step_graph=step_graph,
                       prefix_sharing=prefix_sharing, admission=admission,
                       device=device,
                       mesh=serve_mesh_for(mesh_shape, mesh_devices, device))
    if trace is None:
        trace = make_trace(cfg.vocab_size, n_requests, max_len=max_len,
                           seed=seed, dup_rate=dup_rate,
                           prompt_len=prompt_len,
                           max_new_tokens=max_new_tokens)
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(eng.device)
        torch.cuda.reset_peak_memory_stats(eng.device)
        base = torch.cuda.memory_allocated(eng.device)
    stats = eng.run_trace(trace)
    if cuda:
        stats["run_peak_bytes"] = (torch.cuda.max_memory_allocated(eng.device)
                                   - base)
    stats["streams"] = {rid: list(r.tokens)
                        for rid, r in sorted(eng.done.items())}
    stats["tokens_per_request"] = {rid: len(t)
                                   for rid, t in stats["streams"].items()}
    stats["block_leaks"] = eng.block_leaks()
    return stats


def serve_via_pilots(archs: list[str], n_requests: int = 8,
                     n_steps: int = 400, slots: int = 8, max_len: int = 1024,
                     *, smoke: bool = False, device="cuda",
                     traces: list[list[dict]] | None = None,
                     idle_grace: float = 2.0) -> dict:
    """Several inference servers (different models!) multiplexed over ONE
    pilot — container late-binding for serving.  Each arch is a ``serve``
    image of shape ``custom:<max_len>x<slots>`` on the hand-written kernels
    (its ``flags``: `KERNEL_FLAGS`), full width unless ``smoke``; its
    payload answers ``traces[i]`` (default: a ``make_trace`` trace from
    seed i) on weights from seed 0.  Task i hints task i+1's image so the
    pilot prefetches the next pull during the current run.

    Returns ``drained``, the repo's and the registry's stats, one record
    per payload (``arch``, ``exitcode``, ``bind_seconds``, ``bind_cached``,
    the serve telemetry ``serve``, ``engine`` and ``tokens``) and the
    ``sim`` and ``pilot`` objects."""
    sim = ClusterSim(device=device)
    images = [PayloadImage(arch=a, shape=f"custom:{max_len}x{slots}",
                           mode="serve", smoke=smoke, flags=KERNEL_FLAGS)
              for a in archs]
    tids = []
    for i, img in enumerate(images):
        if traces is not None:
            trace = traces[i]
        else:
            trace = make_trace(img.config().vocab_size, n_requests,
                               max_len=max_len, seed=i)
        hint = images[i + 1] if i + 1 < len(images) else None
        tids.append(sim.repo.submit(
            img, n_steps=n_steps, prefetch_hint=hint,
            payload_spec={"trace": trace, "max_len": max_len,
                          "slots": slots}))
    (s,) = sim.provision(1)
    pilot = sim.spawn_pilot(s, PilotConfig(max_payloads=len(archs) + 1,
                                           idle_grace=idle_grace))
    ok = sim.run_until_drained(timeout=600.0)
    sim.join_all(timeout=30.0)
    payloads = []
    for i, (tid, arch) in enumerate(zip(tids, archs)):
        r = sim.repo.result(tid)
        h = pilot.history[i] if i < len(pilot.history) else {}
        tel = r.telemetry if r is not None else {}
        payloads.append({
            "arch": arch, "exitcode": r.exitcode if r else None,
            "bind_seconds": h.get("bind_seconds"),
            "bind_cached": h.get("bind_cached"),
            "error": tel.get("error", h.get("error")),
            "serve": tel.get("serve", {}), "engine": tel.get("engine", {}),
            "tokens": tel.get("tokens", {})})
    return {"drained": ok, "repo": sim.repo.stats(),
            "registry": dict(sim.registry.stats), "payloads": payloads,
            "sim": sim, "pilot": pilot}


def _fleet_image(arch, max_len, slots, smoke, draft=None,
                 role="unified", mesh_shape=None) -> PayloadImage:
    """The serve image every server of a fleet binds: ``arch`` of shape
    ``custom:<max_len>x<slots>`` on the hand-written kernels, full width
    unless ``smoke``, in serving ``role``, over a mesh of ``mesh_shape``
    (None: one device); ``draft`` names a draft arch's image (None and
    "self" share the plain one)."""
    return PayloadImage(arch=arch, shape=f"custom:{max_len}x{slots}",
                        mode="serve", smoke=smoke, flags=KERNEL_FLAGS,
                        draft=None if draft in (None, "self") else draft,
                        mesh_shape=(None if mesh_shape is None
                                    else serve_mesh_spec(mesh_shape).shape),
                        role=role)


def _server_rows(sim, tids) -> list[dict]:
    """Each server payload's exit code and serve telemetry (the port's
    ``engine`` stats included), for the servers that reported one."""
    rows = []
    for tid in tids:
        r = sim.repo.result(tid)
        if r is None:
            continue
        tel = r.telemetry
        rows.append({"task_id": tid, "pilot": r.pilot_id,
                     "exitcode": r.exitcode,
                     "error": tel.get("error"),
                     "serve": tel.get("serve", {}),
                     "engine": tel.get("engine", {})})
    return rows


def serve_fleet(arch: str, n_requests: int, n_pilots: int, *,
                slots: int = 8, max_len: int = 1024,
                fail_at: int | None = None, fail_count: int = 1,
                lease_ttl: float = 0.5, registry=None, seed: int = 0,
                draft: str | None = None, spec_k: int = 4, robustness=None,
                chaos_plan=None, poison: int = 0, mesh_shape=None,
                mesh_devices=None, trace: list[dict] | None = None,
                smoke: bool = False, device="cuda") -> dict:
    """Fleet serve: N pilots on ``device`` lease requests from one pool.
    Each binds the `_fleet_image` of ``arch`` (weights from seed 0) and
    serves ``slots`` requests at a time; ``trace`` defaults to a
    ``make_trace`` trace from ``seed``.

    ``fail_at`` hard-kills ``fail_count`` lease-holding pilots (one at
    ``fail_at`` settled requests, the next one ``fail_at`` later, ...) —
    the requeue-on-pilot-failure path.  ``draft`` turns on speculative
    decoding on every server: a draft arch name, or ``"self"`` for the
    self-draft ablation (the image's fixed draft seed keeps requeued
    requests replaying bitwise on survivors).

    Chaos drills: ``robustness`` (a
    :class:`~repro_torch.serving.dispatch.RobustnessPolicy`) turns on the
    dispatcher's gray-failure hardening; ``chaos_plan`` (a
    :class:`~repro_torch.core.chaos.FaultPlan`) runs a
    :class:`~repro_torch.core.chaos.ChaosController` against the fleet for
    the duration of the trace; ``poison`` appends that many poison request
    entries (lethal while the plan arms them — each kills the pilot that
    fetches it until the pool quarantines it).  ``mesh_shape`` makes every
    server tensor-parallel: each pilot's slice holds the mesh of
    `serve_mesh_for` (``mesh_devices``), and its server shards over it;
    it stays one unit of ``slots`` capacity.

    Returns pool + timing stats and, the port's own, ``servers``: each
    server payload's exit code and serve telemetry; the caller owns no
    threads when this returns (fleet drained, pool closed).
    """
    from repro_torch.core.chaos import ChaosController

    mesh = serve_mesh_for(mesh_shape, mesh_devices, device)
    img = _fleet_image(arch, max_len, slots, smoke, draft,
                       mesh_shape=mesh_shape)
    sim = ClusterSim(registry=registry, device=device)
    pool = FleetDispatcher(lease_ttl=lease_ttl, policy=robustness)
    if trace is None:
        trace = make_trace(img.config().vocab_size, n_requests,
                           max_len=max_len, seed=seed)
    else:
        trace = list(trace)
    poison_rids = list(range(n_requests, n_requests + poison))
    for rid in poison_rids:
        trace.append({"rid": rid, "prompt": [1, 2, 3, 4],
                      "max_new_tokens": 4, "poison": True})
    fleet = sim.spawn_fleet(n_pilots, PilotConfig(max_payloads=2,
                                                  idle_grace=0.3), mesh=mesh)
    server_spec = {"slots": slots, "max_len": max_len}
    if mesh is not None:
        # the startup spec names the geometry too, so telemetry and dumps
        # of the spec show what was served
        server_spec["mesh_shape"] = list(mesh.spec.shape)
    if draft is not None:
        server_spec.update({"spec": "draft", "spec_k": spec_k})
    tids = fleet.submit_servers(img, pool.name, n=n_pilots,
                                spec=server_spec)
    # submit traffic only once the fleet is up and WARM, so TTFT measures
    # serving (queue wait + requeue delay), not server cold start
    if not pool.wait_servers(n_pilots, timeout=300.0):
        pool.close()
        fleet.drain_all()
        fleet.join_all(30.0)
        raise RuntimeError(
            f"only {len(pool.servers)}/{n_pilots} servers came up within "
            f"300s — refusing to serve traffic into a half-started fleet: "
            f"{_server_rows(sim, tids)}")
    ctl = (ChaosController(sim, fleet, pool=pool, plan=chaos_plan)
           if chaos_plan is not None else None)
    t0 = time.monotonic()
    if ctl is not None:
        ctl.start()            # t=0 for the plan's fault offsets
    pool.submit_trace(trace)
    pool.seal()                # the trace is the whole workload
    failed_pilots: list[str] = []
    try:
        for k in range(fail_count if fail_at else 0):
            if not pool.wait_completed(fail_at * (k + 1), timeout=300.0):
                break
            victim = _pick_victim(fleet, pool, exclude=failed_pilots)
            if victim is None:
                break
            failed_pilots.append(victim.pilot_id)
            sim.fail_node(victim.slice.slice_id)
        ok = pool.wait_all(timeout=600.0)
    finally:
        if ctl is not None:
            ctl.stop()
        pool.close()
        fleet.drain_all()
        fleet.join_all(30.0)
    wall = time.monotonic() - t0
    fleet.reap()
    stats = pool.stats()
    recs = pool.records()
    ttfts = [r.first_token_s for r in recs.values()
             if r.first_token_s is not None]
    goodput = sum(len(r.tokens) for r in recs.values()
                  if r.tokens is not None) / wall if wall else 0.0
    # same percentile definition as ServeEngine._stats, so fleet and
    # single-engine ttft_p*_s rows are directly comparable
    pct = lambda v, q: float(np.percentile(v, q)) if v else None  # noqa: E731
    servers = _server_rows(sim, tids)
    # speculative effectiveness, averaged over the servers that ran with
    # spec on (their serve telemetry survives in the repo's task results)
    spec_rows = [r["serve"] for r in servers
                 if r["serve"].get("spec") == "draft"]
    mean = lambda k: (sum(s[k] for s in spec_rows) / len(spec_rows)  # noqa: E731
                      if spec_rows else 0.0)
    # block-pool leak audit: every server that exited gracefully reports
    # its engine's residual allocation (killed servers can't — their KV
    # state died with the simulated node)
    leaked = sum(r["serve"]["fleet"].get("leaked_blocks", 0)
                 for r in servers if r["serve"].get("fleet"))
    return {
        "drained": ok,
        "wall_s": wall,
        "goodput_tok_per_s": goodput,
        "ttft_p50_s": pct(ttfts, 50),
        "ttft_p99_s": pct(ttfts, 99),
        "failed_pilots": failed_pilots,
        "pilot_seconds": fleet.pilot_seconds(),
        "results": pool.results(),
        "spec_servers": len(spec_rows),
        "acceptance_rate": mean("acceptance_rate"),
        "tokens_per_step": mean("tokens_per_step"),
        "leaked_blocks": leaked,
        "poison_rids": poison_rids,
        "quarantined_rids": sorted(r.rid for r in recs.values()
                                   if r.quarantined),
        "fail_reasons": {r.rid: r.fail_reason for r in recs.values()
                         if r.failed},
        "chaos": ctl.stats() if ctl is not None else None,
        "servers": servers,
        **stats,
    }


def _pct(v, q):
    return float(np.percentile(v, q)) if v else None


def _disagg_pools(router, smoke, arch, max_len, slots):
    """The prefill and decode images of a disaggregated fleet (the role is
    part of the image key) and each pool's server spec, its servers
    labelled with their pool."""
    imgs = {role: _fleet_image(arch, max_len, slots, smoke, role=role)
            for role in ("prefill", "decode")}
    specs = {role: {"slots": slots, "max_len": max_len,
                    "server_labels": {"pool": role}}
             for role in ("prefill", "decode")}
    pools = {"prefill": router.prefill, "decode": router.decode}
    return imgs, specs, pools


def serve_disagg(arch: str, n_requests: int, *, prefill_pilots: int = 2,
                 decode_pilots: int = 2, slots: int = 8, max_len: int = 1024,
                 fail_prefill_at: int | None = None,
                 fail_decode_at: int | None = None, lease_ttl: float = 0.5,
                 registry=None, seed: int = 0,
                 trace: list[dict] | None = None, smoke: bool = False,
                 device="cuda") -> dict:
    """Disaggregated fleet serve on ``device``: prompts lease into a pool of
    ``prefill_pilots`` prefill-role servers whose engines export KV block
    handoffs; each completed prefill becomes a lease in the decode pool
    (the :class:`~repro_torch.serving.dispatch.DisaggRouter` forward),
    where ``decode_pilots`` decode-role servers resume each stream from its
    handoff.  Every server binds the `_fleet_image` of ``arch`` with its
    role (weights from seed 0); ``trace`` defaults to a ``make_trace``
    trace from ``seed``.

    Each role's fleet is labelled with its pool, so its pilots run only
    that role's servers (the reference's fleets share one task repo
    unlabelled, and a pilot of one may serve the other role).
    ``fail_prefill_at`` / ``fail_decode_at`` hard-kill a lease-holding
    pilot of that stage once K requests have settled there: a dead prefill
    pilot's prompts replay from the PROMPT on survivors; a dead decode
    pilot's streams replay from the HANDOFF (the prompt is never
    prefilled again).  Either replay reproduces the lost tokens bitwise.

    Returns the run's stats (TTFT at the prefill export, the resume time
    at the decode import, goodput, leaks, exports and imports) and, the
    port's own, each handoff's export and import milliseconds and wire
    bytes over the servers that ended gracefully, ``servers``: each
    pool's server rows (pilot, exit code, serve telemetry, engine stats),
    and ``pilots``: each role's fleet."""
    from repro_torch.serving.dispatch import DisaggRouter

    sim = ClusterSim(registry=registry, device=device)
    router = DisaggRouter(lease_ttl=lease_ttl)
    imgs, specs, pools = _disagg_pools(router, smoke, arch, max_len, slots)
    if trace is None:
        trace = make_trace(imgs["prefill"].config().vocab_size, n_requests,
                           max_len=max_len, seed=seed)
    counts = {"prefill": prefill_pilots, "decode": decode_pilots}
    fleets = {role: sim.spawn_fleet(n, PilotConfig(max_payloads=2,
                                                   idle_grace=0.3),
                                    labels={"pool": role})
              for role, n in counts.items()}
    tids = {role: fleets[role].submit_servers(
                imgs[role], pools[role].name, n=counts[role],
                spec=specs[role])
            for role in counts}
    for role, n in counts.items():
        if not pools[role].wait_servers(n, timeout=300.0):
            router.close()
            for f in fleets.values():
                f.drain_all()
                f.join_all(30.0)
            raise RuntimeError(
                f"only {len(pools[role].servers)}/{n} {role} servers came "
                f"up within 300s: {_server_rows(sim, tids[role])}")
    pilots = {role: [p.pilot_id for p in f.members]
              for role, f in fleets.items()}
    t0 = time.monotonic()
    router.submit_trace(trace)
    router.seal()
    failed = {"prefill": [], "decode": []}
    try:
        for role, at in (("prefill", fail_prefill_at),
                         ("decode", fail_decode_at)):
            if at is None or not pools[role].wait_completed(at,
                                                            timeout=300.0):
                continue
            victim = _pick_victim(fleets[role], pools[role])
            if victim is not None:
                failed[role].append(victim.pilot_id)
                sim.fail_node(victim.slice.slice_id)
        ok = router.wait_all(timeout=600.0)
    finally:
        router.close()
        for f in fleets.values():
            f.drain_all()
            f.join_all(30.0)
    wall = time.monotonic() - t0
    for f in fleets.values():
        f.reap()
    # end-to-end TTFT: the first generated token exists at the prefill
    # export (it rides the handoff), so the prefill-stage records, timed
    # from the ORIGINAL submit, hold the time to first token.  The decode
    # stage's records time the same start to the import: the resume time
    recs = router.decode.records()
    ttfts = [r.first_token_s for r in router.prefill.records().values()
             if r.first_token_s is not None]
    resumes = [r.first_token_s for r in recs.values()
               if r.first_token_s is not None]
    goodput = sum(len(r.tokens) for r in recs.values()
                  if r.tokens is not None) / wall if wall else 0.0
    servers = {role: _server_rows(sim, t) for role, t in tids.items()}
    rows = servers["prefill"] + servers["decode"]
    leaked = sum(r["serve"]["fleet"].get("leaked_blocks", 0)
                 for r in rows if r["serve"].get("fleet"))
    handoff = {k: [x for r in rows for x in r["engine"].get(k) or ()]
               for k in ("handoff_export_ms", "handoff_import_ms",
                         "handoff_bytes")}
    return {
        "drained": ok,
        "wall_s": wall,
        "goodput_tok_per_s": goodput,
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p99_s": _pct(ttfts, 99),
        "resume_p50_s": _pct(resumes, 50),
        "resume_p99_s": _pct(resumes, 99),
        "failed_pilots": failed,
        "pilots": pilots,
        "pilot_seconds": sum(f.pilot_seconds() for f in fleets.values()),
        "results": router.results(),
        "leaked_blocks": leaked,
        "prefills_exported": sum(r["serve"].get("prefills_exported") or 0
                                 for r in rows),
        "handoffs_imported": sum(r["serve"].get("handoffs_imported") or 0
                                 for r in rows),
        "export_ms_p50": _pct(handoff["handoff_export_ms"], 50),
        "export_ms_max": max(handoff["handoff_export_ms"], default=None),
        "import_ms_p50": _pct(handoff["handoff_import_ms"], 50),
        "import_ms_max": max(handoff["handoff_import_ms"], default=None),
        "handoff_bytes_mean": (float(np.mean(handoff["handoff_bytes"]))
                               if handoff["handoff_bytes"] else None),
        "handoff_bytes_max": max(handoff["handoff_bytes"], default=None),
        "pool_pressure": router.pool_pressure(),
        "stats": router.stats(),
        "servers": servers,
    }


def serve_disagg_schedule(arch: str, schedule: list[tuple[float, dict]], *,
                          slots: int = 8, max_len: int = 1024,
                          prefill_policy=None, decode_policy=None,
                          initial_pilots: int = 1, lease_ttl: float = 0.5,
                          idle_grace: float = 0.5, registry=None,
                          smoke: bool = False, device="cuda") -> dict:
    """Disaggregated fleets on ``device`` under TWO independent autoscalers,
    one per role pool, each reading its own label's ``pool_pressure()``
    slice: a prefill-bound trace grows only the prefill fleet, a
    decode-bound one only the decode fleet (each fleet labelled with its
    pool, so its pilots, joiners included, run only its role's servers).
    A pool whose policy is None keeps its ``initial_pilots``."""
    from repro_torch.core.autoscaler import FleetAutoscaler
    from repro_torch.serving.dispatch import DisaggRouter

    sim = ClusterSim(registry=registry, device=device)
    router = DisaggRouter(lease_ttl=lease_ttl)
    imgs, specs, pools = _disagg_pools(router, smoke, arch, max_len, slots)
    policies = {"prefill": prefill_policy, "decode": decode_policy}
    fleets = {role: sim.spawn_fleet(initial_pilots,
                                    PilotConfig(max_payloads=4,
                                                idle_grace=idle_grace),
                                    labels={"pool": role})
              for role in policies}
    scalers = {}
    out: dict = {}
    try:
        if initial_pilots:
            for role, f in fleets.items():
                f.submit_servers(imgs[role], pools[role].name,
                                 n=initial_pilots, spec=specs[role])
            for role, pool in pools.items():
                if not pool.wait_servers(initial_pilots, timeout=300.0):
                    raise RuntimeError(f"{pool.name} servers not warm "
                                       f"within 300s")
        for role, policy in policies.items():
            if policy is None:
                continue
            scalers[role] = FleetAutoscaler(
                fleets[role], imgs[role], pool=pools[role], pool_label=role,
                policy=policy, spec=specs[role])
            scalers[role].start()
        t0 = time.monotonic()
        for dt, entry in schedule:
            lag = dt - (time.monotonic() - t0)
            if lag > 0:
                time.sleep(lag)
            router.submit(entry)
        router.seal()
        out["drained"] = router.wait_all(timeout=600.0)
        out["wall_s"] = time.monotonic() - t0
    finally:
        for sc in scalers.values():
            sc.stop()
        router.close()
        for f in fleets.values():
            f.drain_all()
            f.join_all(30.0)
            f.reap()
    recs = router.decode.records()
    ttfts = [r.first_token_s for r in recs.values()
             if r.first_token_s is not None]
    out.update({
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p99_s": _pct(ttfts, 99),
        "pilot_seconds": {role: f.pilot_seconds()
                          for role, f in fleets.items()},
        "peak_pilots": {role: (scalers[role].peak_live if role in scalers
                               else None) for role in fleets},
        "results": router.results(),
        "stats": router.stats(),
    })
    for role, sc in scalers.items():
        out.setdefault("autoscale", {})[role] = sc.stats()
    return out


def make_bursty_schedule(trace: list[dict], *, bursts: int, burst_s: float,
                         gap_s: float, seed: int = 0) -> list[tuple[float, dict]]:
    """Square-wave arrival schedule with Poisson arrivals inside each high
    phase: the trace is split evenly across ``bursts`` bursts; within a
    burst, inter-arrival gaps are exponential (rate = burst size /
    burst_s, clipped to the burst window), and between bursts the pool
    goes quiet for ``gap_s`` — the demand shape an autoscaler must track
    without flapping."""
    rng = np.random.default_rng(seed)
    per = (len(trace) + bursts - 1) // bursts
    out: list[tuple[float, dict]] = []
    for b in range(bursts):
        chunk = trace[b * per:(b + 1) * per]
        if not chunk:
            break
        t = b * (burst_s + gap_s)
        rate = len(chunk) / burst_s
        offs = np.minimum(np.cumsum(rng.exponential(1.0 / rate,
                                                    size=len(chunk))),
                          burst_s)
        for off, e in zip(offs, chunk):
            out.append((t + float(off), e))
    return out


def serve_fleet_schedule(arch: str, schedule: list[tuple[float, dict]], *,
                         slots: int = 8, max_len: int = 1024,
                         policy=None, n_pilots: int | None = None,
                         initial_pilots: int = 1, lease_ttl: float = 0.5,
                         idle_grace: float = 0.5, registry=None,
                         settle_to_zero: bool = True, smoke: bool = False,
                         device="cuda") -> dict:
    """Drive a serving fleet on ``device`` through a WALL-CLOCK arrival
    schedule (``[(t_offset_s, entry), ...]``, sorted by offset); every
    server binds the `_fleet_image` of ``arch``.

    ``policy`` (an :class:`~repro_torch.core.autoscaler.AutoscalePolicy`)
    runs the fleet under the demand-driven autoscaler starting from
    ``initial_pilots``; ``policy=None`` runs a STATIC fleet of
    ``n_pilots`` — the peak-sized baseline the autoscaler is judged
    against.  Returns pool stats + pool-level TTFT percentiles +
    ``pilot_seconds`` (fleet-lifetime slice holding, the cost metric) and,
    when autoscaled, the decision ledger / flap count / scale-to-zero
    outcome."""
    from repro_torch.core.autoscaler import FleetAutoscaler

    sim = ClusterSim(registry=registry, device=device)
    pool = FleetDispatcher(lease_ttl=lease_ttl)
    img = _fleet_image(arch, max_len, slots, smoke)
    spec = {"slots": slots, "max_len": max_len}
    n_start = n_pilots if policy is None else max(policy.min_pilots,
                                                 initial_pilots)
    if policy is None and n_pilots is None:
        raise ValueError("static mode needs n_pilots")
    fleet = sim.spawn_fleet(n_start, PilotConfig(max_payloads=4,
                                                 idle_grace=idle_grace))
    scaler = None
    out: dict = {}
    try:
        if n_start:
            fleet.submit_servers(img, pool.name, n=n_start, spec=spec)
            if not pool.wait_servers(n_start, timeout=300.0):
                raise RuntimeError(
                    f"only {len(pool.servers)}/{n_start} servers warm "
                    f"within 300s")
        if policy is not None:
            scaler = FleetAutoscaler(fleet, img, pool=pool, policy=policy,
                                     spec=spec)
            scaler.start()
        t0 = time.monotonic()
        for dt, entry in schedule:
            lag = dt - (time.monotonic() - t0)
            if lag > 0:
                time.sleep(lag)
            pool.submit(entry)
        pool.seal()
        ok = pool.wait_all(timeout=600.0)
        wall = time.monotonic() - t0
        out["drained"] = ok
        out["wall_s"] = wall
        if scaler is not None and policy.min_pilots == 0 and settle_to_zero:
            # the empty-trace epilogue: demand is 0, so the loop must shed
            # every pilot (victims exit via drain/idle_grace) — the
            # scale-to-zero half of the (g)->(h) lifecycle
            budget = (policy.down_cooldown
                      + policy.down_stable_ticks * policy.interval + 30.0)
            deadline = time.monotonic() + budget
            while fleet.size() > 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            out["scaled_to_zero"] = fleet.size() == 0
            out["scale_to_zero_s"] = time.monotonic() - t0 - wall
    finally:
        if scaler is not None:
            scaler.stop()
        pool.close()
        fleet.drain_all()
        fleet.join_all(30.0)
        fleet.reap()
    recs = pool.records()
    ttfts = [r.first_token_s for r in recs.values()
             if r.first_token_s is not None]
    pct = lambda v, q: float(np.percentile(v, q)) if v else None  # noqa: E731
    out.update({
        "ttft_p50_s": pct(ttfts, 50),
        "ttft_p99_s": pct(ttfts, 99),
        "pilot_seconds": fleet.pilot_seconds(),
        "results": pool.results(),
        **pool.stats(),
    })
    if scaler is not None:
        out["autoscale"] = scaler.stats()
        out["decisions"] = [dataclasses.asdict(d) for d in scaler.decisions]
        out["t_start"] = t0
    return out


def _pick_victim(fleet, pool, *, exclude=()):
    """The live pilot holding the most request leases (never a survivor of
    a previous kill round that holds none — killing an idle pilot exercises
    nothing)."""
    holders = pool.lease_holders()
    best, best_n = None, -1
    for p in fleet.live():
        if p.pilot_id in exclude:
            continue
        n = len(holders.get(p.pilot_id, []))
        if n > best_n:
            best, best_n = p, n
    return best if best_n > 0 else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m",
                    help="one of " + ", ".join(list_archs()))
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv", choices=("paged", "dense"), default=None,
                    help="KV layout (default: paged where the arch pages)")
    ap.add_argument("--spec", choices=("off", "draft"), default="off",
                    help="draft-and-verify speculative decoding (self-draft)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative step")
    ap.add_argument("--prefill", choices=("oneshot", "chunked"),
                    default="oneshot",
                    help="admission: the whole prompt at once, or in chunks "
                         "interleaved with decode")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="tokens per chunk of a chunked admission (a "
                         "multiple of the block size, 16, when paged)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="paged pool size (default: dense-equivalent)")
    ap.add_argument("--dup-rate", type=float, default=0.0,
                    help="fraction of repeated prompts (prefix-cache hits)")
    ap.add_argument("--eager", action="store_true",
                    help="run every function eagerly (the decode step or "
                         "spec pair, admissions, chunks), not as CUDA "
                         "graphs")
    ap.add_argument("--wave", action="store_true",
                    help="wave admission: refill slots only once all are "
                         "free (the static-batching baseline)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=parse_mesh_shape, default=None,
                    help="serve over a device mesh, 'AxB' = (data, model): "
                         "'1x2' splits params and KV pools on the head axis "
                         "over 2 ranks; a data axis above 1 replicates them "
                         "(MoE decode splits its experts over it); every "
                         "decoder arch (direct and fleet modes)")
    ap.add_argument("--mesh-devices", default=None,
                    help="comma-separated devices of the mesh's ranks, e.g. "
                         "'cuda:0,cuda:0' for two ranks on one card "
                         "(default: cuda:0..N-1; every rank on the CPU "
                         "with --device cpu)")
    ap.add_argument("--via-pilots", action="store_true",
                    help="serve each arch of --archs as a payload that one "
                         "pilot late-binds in turn")
    ap.add_argument("--archs", default="smollm-360m,mamba2-370m",
                    help="comma-separated archs for --via-pilots")
    ap.add_argument("--draft", default=None,
                    help="fleet serve: speculative decoding on every "
                         "server, a draft arch or 'self' for the self-draft "
                         "ablation")
    ap.add_argument("--pilots", type=int, default=None,
                    help="fleet serve: N pilots lease requests from one "
                         "shared pool")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="fleet serve: hard-kill a lease-holding pilot "
                         "after K completed requests")
    ap.add_argument("--chaos", action="store_true",
                    help="fleet serve: run the canned chaos drill (crash + "
                         "stall + slow + flaky heartbeat + one poison "
                         "request) with gray-failure hardening on")
    ap.add_argument("--hedge", type=float, default=None,
                    help="fleet serve: enable hedged re-dispatch with this "
                         "straggler budget factor (x pool p95 service time)")
    ap.add_argument("--quarantine-after", type=int, default=None,
                    help="fleet serve: quarantine a request once this many "
                         "distinct pilots died holding it (0 disables)")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serve: a prefill fleet exports KV "
                         "handoffs that a decode fleet resumes (pool sizes "
                         "via --prefill-pilots/--decode-pilots)")
    ap.add_argument("--prefill-pilots", type=int, default=2,
                    help="disagg: prefill pool size")
    ap.add_argument("--decode-pilots", type=int, default=2,
                    help="disagg: decode pool size")
    ap.add_argument("--fail-prefill-at", type=int, default=None,
                    help="disagg: kill a prefill pilot after K settled "
                         "prefills (replay-from-prompt)")
    ap.add_argument("--fail-decode-at", type=int, default=None,
                    help="disagg: kill a decode pilot after K finished "
                         "streams (replay-from-handoff)")
    ap.add_argument("--autoscale", action="store_true",
                    help="fleet serve on a bursty square-wave trace with "
                         "the demand-driven autoscaler (--pilots caps the "
                         "fleet; starts at 1, scales to zero in the gaps)")
    args = ap.parse_args(argv)
    args.mesh_devices = (args.mesh_devices.split(",") if args.mesh_devices
                         else None)
    if args.disagg:
        out = serve_disagg(args.arch, args.requests,
                           prefill_pilots=args.prefill_pilots,
                           decode_pilots=args.decode_pilots,
                           slots=args.slots, max_len=args.max_len,
                           fail_prefill_at=args.fail_prefill_at,
                           fail_decode_at=args.fail_decode_at,
                           seed=args.seed, smoke=args.smoke,
                           device=args.device)
        for k in ("results", "pool_pressure", "servers"):
            out.pop(k)
        print(json.dumps(out, default=str))
        return 0 if out["drained"] else 1
    if args.autoscale:
        return _autoscale_main(args)
    if args.pilots:
        return _fleet_main(args)
    if args.via_pilots:
        out = serve_via_pilots(args.archs.split(","), args.requests,
                               slots=args.slots, max_len=args.max_len,
                               smoke=args.smoke, device=args.device)
        for p in out["payloads"]:
            p["tokens"] = sum(len(t) for t in p["tokens"].values())
        print(json.dumps({k: out[k] for k in ("drained", "repo", "registry",
                                              "payloads")}))
        return 0 if all(p["exitcode"] == 0 for p in out["payloads"]) else 1
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    stats = serve_direct(cfg, args.requests, args.slots, args.max_len,
                         seed=args.seed, num_blocks=args.num_blocks,
                         dup_rate=args.dup_rate, kv=args.kv, spec=args.spec,
                         spec_k=args.spec_k, prefill=args.prefill,
                         prefill_chunk=args.prefill_chunk,
                         step_graph=False if args.eager else None,
                         admission="wave" if args.wave else "continuous",
                         device=args.device, mesh_shape=args.mesh,
                         mesh_devices=args.mesh_devices)
    del stats["streams"]
    if args.mesh is not None:
        print(f"[mesh] shape={'x'.join(map(str, args.mesh))} "
              f"devices={stats['mesh_devices']} "
              f"kv_pool_bytes_per_device={stats['kv_pool_bytes_per_device']} "
              f"(total {stats['kv_pool_bytes']})")
    print(json.dumps(stats))


def _fleet_main(args) -> int:
    """``--pilots N``: `serve_fleet`, with the chaos drill's policy and
    plan when asked; prints the pool's stats (not the streams)."""
    robustness, chaos_plan, poison = None, None, 0
    if args.chaos or args.hedge is not None \
            or args.quarantine_after is not None:
        from repro_torch.serving.dispatch import RobustnessPolicy
        robustness = RobustnessPolicy()
        if args.hedge is not None:
            robustness.hedge_factor = args.hedge
        if args.quarantine_after is not None:
            robustness.quarantine_after = args.quarantine_after
    if args.chaos:
        from repro_torch.core.chaos import FaultPlan, FaultSpec
        chaos_plan = FaultPlan(faults=[
            FaultSpec(kind="crash", at_s=0.5),
            FaultSpec(kind="stall", at_s=1.0, duration_s=2.0),
            FaultSpec(kind="slow", at_s=1.5, duration_s=2.0, factor=5.0),
            FaultSpec(kind="flaky_heartbeat", at_s=1.5, duration_s=2.0),
        ], poison=True)
        poison = 1
    out = serve_fleet(args.arch, args.requests, args.pilots,
                      slots=args.slots, max_len=args.max_len,
                      fail_at=args.fail_at, seed=args.seed,
                      draft=args.draft, spec_k=args.spec_k,
                      robustness=robustness, chaos_plan=chaos_plan,
                      poison=poison, mesh_shape=args.mesh,
                      mesh_devices=args.mesh_devices, smoke=args.smoke,
                      device=args.device)
    out.pop("results")
    if args.mesh is not None:
        print(f"[mesh] shape={'x'.join(map(str, args.mesh))} "
              f"(fleet: every server shards over its own mesh)")
    if args.draft:
        print(f"[spec] servers={out['spec_servers']} "
              f"acceptance_rate={out['acceptance_rate']:.3f} "
              f"tokens_per_step={out['tokens_per_step']:.2f}")
    print(json.dumps(out, default=str))
    return 0 if out["drained"] else 1


def _autoscale_main(args) -> int:
    """``--autoscale``: `serve_fleet_schedule` on a 3-burst square wave
    (1 s bursts, 5 s gaps) under the autoscaler, at most ``--pilots``
    (default 4) pilots, from one up and down to zero."""
    from repro_torch.core.autoscaler import AutoscalePolicy
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    trace = make_trace(cfg.vocab_size, args.requests, max_len=args.max_len,
                       seed=args.seed)
    schedule = make_bursty_schedule(trace, bursts=3, burst_s=1.0, gap_s=5.0)
    out = serve_fleet_schedule(
        args.arch, schedule, slots=args.slots, max_len=args.max_len,
        policy=AutoscalePolicy(min_pilots=0, max_pilots=args.pilots or 4,
                               slots_per_pilot=args.slots),
        smoke=args.smoke, device=args.device)
    out.pop("results")
    out.pop("t_start", None)
    print(json.dumps(out, default=str))
    return 0 if out["drained"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
