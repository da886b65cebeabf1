"""Serve entry point of the port: a request trace answered by one engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --requests 16 --slots 8 --max-len 1024 [--spec draft] [--kv dense] \
        [--prefill chunked --prefill-chunk 128] [--eager]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --via-pilots \\
        --archs smollm-360m,mamba2-370m [--smoke --device cpu]

Port of ``make_trace`` and ``serve_direct`` from ``repro.launch.serve``.
The serve entry point builds the main path with the hand-written kernels
(``attn_impl="pallas"``, ``norm_impl="pallas"``, ``moe_impl="gmm"`` for
an MoE arch such as granite-moe-3b-a800m, ``ssm_impl="pallas"`` for a
Mamba-2 arch such as mamba2-370m) on ``device`` ("cuda" by default;
without a card it raises unless the caller asks for "cpu"): a paged or
dense KV cache, with or without draft-and-verify speculation.  An
attention-free arch serves on the dense layout (its per-row SSM state has
nothing to page) with speculation off, as the reference's engine chooses.
Admission is one-shot or chunked (``prefill="chunked"``); on the card a
``spec="off"`` engine replays its decode step as a captured CUDA graph
(``step_graph=False``, ``--eager``: the eager step).

``--via-pilots`` (`serve_via_pilots`, port of the reference's) submits
each arch of ``--archs`` as a ``serve`` payload image and lets ONE pilot,
holding one slice of ``device``, late-bind them in turn: each engine run,
trace and all, is a payload; task i carries a prefetch hint for task
i+1's image, so the next image's pull and warm-up overlap the current
server's run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.cluster import ClusterSim
from repro_torch.core.images import PayloadImage
from repro_torch.core.pilot import PilotConfig
from repro_torch.models.api import build_model, resolve_device
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
                 device="cuda") -> ServeEngine:
    """The serve entry point's engine: ``cfg`` on the hand-written kernels,
    weights from ``seed``, a paged pool of ``num_blocks`` blocks (or a
    dense cache with ``kv="dense"``).  ``spec="draft"`` proposes
    ``spec_k`` tokens a step from ``draft_cfg`` with weights from
    ``draft_seed`` (``draft_cfg=None``: the target drafts for itself).
    ``prefill``, ``prefill_chunk``, ``step_graph`` and ``prefix_sharing``
    go to the engine."""
    dev = resolve_device(device)
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
                       device=dev)


def serve_direct(cfg, n_requests: int, slots: int, max_len: int,
                 seed: int = 0, num_blocks: int | None = None,
                 block_size: int = 16,
                 prompt_len: tuple[int, int] | None = None,
                 max_new_tokens: int | None = None, kv: str | None = None,
                 spec: str = "off", spec_k: int = 4, draft_cfg=None,
                 draft_seed: int = 0, prefill: str = "oneshot",
                 prefill_chunk: int = 32, step_graph: bool | None = None,
                 prefix_sharing: bool = True, device="cuda") -> dict:
    """Build the model from ``seed`` and an engine over it
    (`build_engine`), answer a ``make_trace`` trace, and return the
    engine's stats plus ``streams`` ({rid: tokens}), ``tokens_per_request``
    ({rid: count}) and ``block_leaks``."""
    eng = build_engine(cfg, slots, max_len, seed=seed, num_blocks=num_blocks,
                       block_size=block_size, kv=kv, spec=spec,
                       spec_k=spec_k, draft_cfg=draft_cfg,
                       draft_seed=draft_seed, prefill=prefill,
                       prefill_chunk=prefill_chunk, step_graph=step_graph,
                       prefix_sharing=prefix_sharing, device=device)
    trace = make_trace(cfg.vocab_size, n_requests, max_len=max_len,
                       seed=seed, prompt_len=prompt_len,
                       max_new_tokens=max_new_tokens)
    stats = eng.run_trace(trace)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m",
                    help="smollm-360m, granite-moe-3b-a800m or mamba2-370m")
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
    ap.add_argument("--eager", action="store_true",
                    help="run the decode step eagerly, not as a CUDA graph")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--via-pilots", action="store_true",
                    help="serve each arch of --archs as a payload that one "
                         "pilot late-binds in turn")
    ap.add_argument("--archs", default="smollm-360m,mamba2-370m",
                    help="comma-separated archs for --via-pilots")
    args = ap.parse_args(argv)
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
                         seed=args.seed, kv=args.kv, spec=args.spec,
                         spec_k=args.spec_k, prefill=args.prefill,
                         prefill_chunk=args.prefill_chunk,
                         step_graph=False if args.eager else None,
                         device=args.device)
    del stats["streams"]
    print(json.dumps(stats))


if __name__ == "__main__":
    raise SystemExit(main())
