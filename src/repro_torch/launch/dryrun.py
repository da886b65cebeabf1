"""Dry run: FLOPs, bytes, memory and roofline terms of every (arch x
shape) cell on the production mesh, without a card.

  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
  python -m repro_torch.launch.dryrun --arch starcoder2-3b --serve-mesh 1x2

Port of ``repro.launch.dryrun``, with the H100's peaks
(`repro_torch.launch.hw`).  The reference lowers and compiles each cell's
step for 512 placeholder host devices and reads per-device figures from
XLA's partitioned program.  The port has no partitioner and no compiler:
it runs the cell's step once on meta-device stand-ins
(`repro_torch.launch.specs`), counting every aten op
(`repro_torch.launch.op_cost`), and divides by the sharding rules
(`repro_torch.runtime.sharding`): argument bytes per device are each
leaf's bytes over its spec's shard factor, temp bytes the run's peak of
live bytes over the batch axes' size, FLOPs and fused bytes the counted
global figures over the chips.  That is the ideal split, which a
partitioner may miss; each record's ``notes`` say so.  On a `MeshSpec`
that no process holds there are no transfers to count, and
``collective_s`` is null.

Single-cell mode runs in-process; ``--all`` spawns one subprocess per cell
and writes JSON records under ``results/dryrun_torch/<mesh>/`` (the
reference's are under ``results/dryrun/``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import torch

from repro_torch.configs.base import (
    SHAPES, applicable_shapes, get_config, get_smoke_config, list_archs)
from repro_torch.launch import hw
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import step_cost
from repro_torch.launch.op_stats import (
    collective_stats, cost_summary, memory_summary)
from repro_torch.launch.specs import META, input_specs
from repro_torch.launch.steps import (
    make_prefill_step, make_serve_step, make_train_step)
from repro_torch.models.api import build_model, init_decode_state
from repro_torch.optim.adamw import OptimConfig
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.mesh import DeviceMesh, batch_axes

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# config flags that select a hand-written kernel: (field, value)
KERNEL_FLAGS = (("attn_impl", "pallas"), ("norm_impl", "pallas"),
                ("ssm_impl", "pallas"), ("moe_impl", "gmm"))


def _shardings_for(cfg, shape, mode, mesh, specs, moe_partition="tp",
                   layout="2d"):
    """(in_specs, out_specs, donate_argnums) for the step kind: trees of
    spec tuples shaped as the step's arguments and outputs."""
    if mode == "train":
        state_sh = shd.train_state_shardings(specs[0]["params"], mesh,
                                             moe_partition=moe_partition,
                                             layout=layout)
        batch_sh = shd.batch_shardings(specs[1], mesh, layout)
        return (state_sh, batch_sh), (state_sh, ()), (0,)
    if mode == "prefill":
        param_sh = shd.param_shardings(specs[0], mesh, "serve",
                                       moe_partition=moe_partition,
                                       layout=layout)
        batch_sh = shd.batch_shardings(specs[1], mesh, layout)
        return (param_sh, batch_sh), None, ()
    # decode
    param_sh = shd.param_shardings(specs[0], mesh, "serve",
                                   moe_partition=moe_partition, layout=layout)
    state_sh = shd.decode_state_shardings(specs[1], mesh)
    return (param_sh, state_sh), (None, state_sh), (1,)


def _step_fn(cfg, mode, flags: dict):
    if mode == "train":
        return make_train_step(cfg, OptimConfig(total_steps=10_000))
    if mode == "prefill":
        return make_prefill_step(cfg)
    return make_serve_step(cfg)


def _model_flops(cfg, shape, mode) -> float:
    n = cfg.active_param_count()
    if mode == "train":
        return 6.0 * n * shape.tokens
    if mode == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch          # decode: 1 new token/seq


def refuse_kernel_flags(cfg):
    """Raise ``ValueError`` naming the flag when ``cfg`` selects a
    hand-written kernel: a kernel cannot run on meta tensors, and the
    dry run never swaps its plain version in silently."""
    for field, value in KERNEL_FLAGS:
        if getattr(cfg, field) == value:
            raise ValueError(
                f"{field}={value!r} selects a hand-written kernel, which "
                "cannot run on the meta device the dry run counts on; drop "
                "the flag (the dry run counts the plain path)")


def _leaf_pairs(values, specs):
    """[(tensor, spec)] of the tree ``values`` against the spec tree
    ``specs`` of the same structure (None: no specs)."""
    if isinstance(values, torch.Tensor):
        return [(values, specs)]
    if isinstance(values, dict):
        items = values.items()
    elif isinstance(values, (list, tuple)):
        items = enumerate(values)
    else:
        return []
    return [p for k, v in items
            for p in _leaf_pairs(v, None if specs is None else specs[k])]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _per_device_memory(mc, args, arg_specs, out, mesh, layout):
    """The counted run's memory on one device: arguments by their specs,
    outputs that are argument storage as their argument, other outputs
    over the batch axes where their first dim divides, temp over the
    batch axes."""
    by_storage = {}
    arg_dev = 0
    for t, spec in _leaf_pairs(shd.as_tree(args), arg_specs):
        b = _nbytes(t) // shd.spec_shard_factor(spec or (), mesh)
        key = id(t.untyped_storage())
        if key not in by_storage:
            by_storage[key] = b
            arg_dev += b
    out_dev = alias_dev = 0
    seen = set()
    for t, _ in _leaf_pairs(shd.as_tree(out), None):
        key = id(t.untyped_storage())
        if key in seen:
            continue
        seen.add(key)
        if key in by_storage:
            out_dev += by_storage[key]
            alias_dev += by_storage[key]
            continue
        axis = shd._batch_dim_axis(mesh, t.shape[0], layout) if t.dim() else None
        out_dev += _nbytes(t) // shd.axis_size(mesh, axis) if axis else _nbytes(t)
    batch = shd.axis_size(mesh, batch_axes(mesh, layout))
    return dataclasses.replace(
        mc, argument_bytes=arg_dev, output_bytes=out_dev,
        alias_bytes=alias_dev, peak_temp_bytes=mc.peak_temp_bytes // batch)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             flags: dict | None = None, moe_partition: str = "tp",
             layout: str = "2d", mesh=None) -> dict:
    """The reference's record for one cell, counted on meta stand-ins.
    ``mesh``: the production mesh by default, or a `DeviceMesh`."""
    flags = flags or {}
    cfg = get_config(arch)
    if flags:
        cfg = dataclasses.replace(cfg, **flags)
    refuse_kernel_flags(cfg)
    shape = SHAPES[shape_name]
    mode = shape.mode
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    sizes = shd._sizes(mesh)
    n_chips = math.prod(sizes.values())
    rec = {
        "arch": arch, "shape": shape_name, "mode": mode,
        "mesh": {"shape": list(sizes.values()), "axes": list(sizes)},
        "flags": flags, "moe_partition": moe_partition, "layout": layout,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }

    t0 = time.monotonic()
    specs = input_specs(cfg, shape, mode)
    in_sh, _, _ = _shardings_for(cfg, shape, mode, mesh, specs,
                                 moe_partition, layout)
    step = _step_fn(cfg, mode, flags)
    rec["lower_seconds"] = time.monotonic() - t0
    rec["compile_seconds"] = None
    t1 = time.monotonic()
    with shd.activation_sharding(mesh, layout):
        out, mc = step_cost(step, *specs)
    rec["run_seconds"] = time.monotonic() - t1

    dev = _per_device_memory(mc, specs, in_sh, out, mesh, layout)
    rec["memory"] = memory_summary(dev)
    rec["cost_analysis_raw"] = cost_summary(mc)
    rec["collectives_raw"] = collective_stats(mc)
    flops_dev = mc.flops / n_chips
    bytes_dev = mc.bytes_fused / n_chips
    rec["hlo_cost"] = {
        "flops": flops_dev,
        "bytes_unfused": mc.bytes / n_chips,
        "bytes_fused": bytes_dev,
        "transcendentals": mc.transcendentals / n_chips,
        "collective_bytes": mc.collective_bytes,
        "collective_counts": mc.collective_counts,
        "total_collective_bytes": mc.total_collective_bytes,
        "top_collectives": [
            {"op": k[0], "type": k[1], "trips": k[2], "bytes": v}
            for k, v in mc.top_collectives()],
        "flops_global": mc.flops,
        "bytes_fused_global": mc.bytes_fused,
        "kernel_launches": mc.kernel_launches,
    }

    notes = [
        "per-device figures are the ideal split by the sharding rules "
        "(no partitioner): FLOPs and fused bytes over the chips, argument "
        "bytes over each leaf's shard factor, temp bytes over the batch "
        "axes; the reference reads XLA's partitioned program",
        "compile_seconds is null: the port compiles nothing; run_seconds "
        "is the counted run on meta tensors",
        "total_nonalias_bytes counts aliased (in-place) bytes once; the "
        "reference's formula subtracts them twice",
    ]
    terms = {"compute_s": flops_dev / hw.PEAK_FLOPS,
             "memory_s": bytes_dev / hw.HBM_BW}
    if isinstance(mesh, DeviceMesh):
        terms["collective_s"] = mc.total_collective_bytes / hw.LINK_BW
    else:
        terms["collective_s"] = None
        notes.append("collective_s is null: the mesh is a MeshSpec that no "
                     "process holds, so no transfer ran to be counted; it "
                     "is left out of dominant")
    timed = {k: v for k, v in terms.items() if v is not None}
    terms["dominant"] = max(timed, key=timed.get)
    model_flops = _model_flops(cfg, shape, mode)
    terms["model_flops_global"] = model_flops
    terms["model_flops_per_chip"] = model_flops / n_chips
    terms["useful_flops_ratio"] = (
        model_flops / n_chips / flops_dev if flops_dev else None)
    bound_s = max(timed.values())
    terms["roofline_step_s"] = bound_s
    terms["roofline_fraction"] = (
        (model_flops / n_chips / hw.PEAK_FLOPS) / bound_s if bound_s else None)
    rec["roofline"] = terms
    rec["notes"] = notes

    mem = rec["memory"].get("total_nonalias_bytes")
    rec["fits_hbm"] = None if mem is None else bool(mem < hw.HBM_BYTES)
    return rec


# --------------------------------------------------------------------------
# serve-mesh accounting: per-shard memory / FLOPs for a mesh-bound serve
# engine, without building the mesh (pure shape math on meta stand-ins +
# the serve rules' shard-factor mirrors)
# --------------------------------------------------------------------------


def run_serve_cell(arch: str, *, mesh_shape: tuple = (1, 1),
                   slots: int = 4, max_len: int | None = None,
                   kv: str = "paged", num_blocks: int | None = None,
                   block_size: int = 16, smoke: bool = False,
                   param_dtype=torch.float32, whole=None) -> dict:
    """Roofline accounting for ONE serve engine on a ``(data, model)``
    mesh, the reference's record number for number: per-device bytes
    divide each leaf by the factor the serve rules apply
    (`serve_param_shard_factor`, `serve_state_shard_factor`).

    ``param_dtype`` is the parameters' init dtype: f32 (the reference's
    init makes every leaf f32), or bf16 for the port's serve engine
    (bf16 matrices; norm scales, routers and SSM constants stay f32).
    ``whole`` (a sequence of leaf names) accounts as the port's engine
    places a mesh: those column leaves kept whole on the lead device
    (`sharding.Whole`), replicated leaves once on the lead; the record
    then also has ``whole_leaves`` and, per model rank, lead first,
    ``params_bytes_per_rank``, ``state_bytes_per_rank`` and
    ``kv_pool_bytes_per_rank``; and the same per device of the mesh,
    ``[data row][model rank]`` (``params_bytes_by_device``, ...): every
    data row holds a copy of row 0's placement, MoE leaves kept whole
    included."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    msz = int(mesh_shape[1])
    n_dev = int(mesh_shape[0]) * msz
    ml = max_len or 1024
    params = build_model(cfg).init(0, device=META, dtype=param_dtype).tree()
    state = init_decode_state(cfg, slots, ml, kv=kv, num_blocks=num_blocks,
                              block_size=block_size, device=META)
    whole = None if whole is None else frozenset(whole)
    kv_leaves = {"kp", "vp", "ckvp", "kropep", "k", "v", "ckv", "krope"}

    def _account(tree, factor_fn, only=None):
        # [total, per device, then bytes per model rank, lead first]
        acc = [0, 0] + [0] * msz

        def one(path, leaf):
            if only is not None and shd._leaf_name(path) not in only:
                return
            b = leaf.numel() * leaf.element_size()
            f = factor_fn(path, tuple(leaf.shape), msz)
            if whole is not None and shd._leaf_name(path) in whole:
                f = 1
            acc[0] += b
            acc[1] += b // f
            if f == 1:
                acc[2] += b                          # on the lead device
            else:
                for r in range(msz):
                    acc[2 + r] += b // f
        shd.map_with_path(one, tree)
        return acc

    p = _account(params, shd.serve_param_shard_factor)
    s = _account(state, shd.serve_state_shard_factor)
    k = _account(state, shd.serve_state_shard_factor, only=kv_leaves)

    # decode FLOPs: one token per slot per step.  The column-parallel
    # shards split the matmul work over the model axis; the data axis
    # replicates the engine's batch (one engine spans the whole mesh), so
    # per-device work divides by the MODEL size only.
    flops_global = 2.0 * cfg.active_param_count() * slots
    flops_dev = flops_global / msz
    mem_dev = p[1] + s[1]
    rec = {
        "arch": arch, "mode": "serve", "mesh_shape": list(mesh_shape),
        "mesh_devices": n_dev, "slots": slots, "max_len": ml, "kv": kv,
        "params_bytes": p[0], "params_bytes_per_device": p[1],
        "state_bytes": s[0], "state_bytes_per_device": s[1],
        "kv_pool_bytes": k[0],
        "kv_pool_bytes_per_device": k[1],
        "bytes_per_device": mem_dev,
        "decode_flops": flops_global,
        "decode_flops_per_device": flops_dev,
        "decode_compute_s": flops_dev / hw.PEAK_FLOPS,
        "decode_memory_s": mem_dev / hw.HBM_BW,
        "fits_hbm_per_device": bool(mem_dev < hw.HBM_BYTES),
    }
    if whole is not None:
        rec["whole_leaves"] = sorted(whole)
        rec["params_bytes_per_rank"] = p[2:]
        rec["state_bytes_per_rank"] = s[2:]
        rec["kv_pool_bytes_per_rank"] = k[2:]
        for name, acc in (("params", p), ("state", s), ("kv_pool", k)):
            rec[f"{name}_bytes_by_device"] = [list(acc[2:])
                                              for _ in range(mesh_shape[0])]
    return rec


# --------------------------------------------------------------------------


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for s in applicable_shapes(cfg):
            cells.append((arch, s))
    return cells


def _cell_path(arch, shape_name, multi_pod) -> pathlib.Path:
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    return RESULTS / mesh_tag / f"{arch}__{shape_name}.json"


def run_all(multi_pod: bool, skip_existing: bool, timeout: float = 3000.0):
    cells = all_cells()
    print(f"[dryrun] {len(cells)} cells, multi_pod={multi_pod}")
    failures = []
    for i, (arch, shape_name) in enumerate(cells):
        out = _cell_path(arch, shape_name, multi_pod)
        if skip_existing and out.exists():
            print(f"[{i+1:2d}/{len(cells)}] {arch} x {shape_name}: cached")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape_name]
        if multi_pod:
            cmd.append("--multi-pod")
        t0 = time.monotonic()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=timeout)
            ok = r.returncode == 0 and out.exists()
        except subprocess.TimeoutExpired:
            r, ok = None, False
        dt = time.monotonic() - t0
        status = "ok" if ok else "FAIL"
        print(f"[{i+1:2d}/{len(cells)}] {arch} x {shape_name}: {status} "
              f"({dt:.0f}s)")
        if not ok:
            failures.append((arch, shape_name))
            if r is not None:
                tail = (r.stderr or r.stdout or "").strip().splitlines()[-12:]
                print("    " + "\n    ".join(tail))
    print(f"[dryrun] done; {len(failures)} failures: {failures}")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="The port's dry run: count a cell's step on meta "
                    "tensors and write its roofline record.",
        epilog="The reference's --save-hlo has no counterpart: the port "
               "compiles no HLO.")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--moe-partition", default="tp", choices=("tp", "ep"))
    ap.add_argument("--layout", default="2d", choices=("2d", "fsdp"))
    ap.add_argument("--flags", default="",
                    help='comma list key=value ArchConfig overrides, e.g. '
                         '"remat=dots,attn_impl=causal_blocked" (a kernel '
                         'flag is refused: kernels do not run on meta)')
    ap.add_argument("--serve-mesh", default=None,
                    help="per-shard serve accounting on a 'DxM' "
                         "(data, model) mesh — pure shape math, no run; "
                         "e.g. '1x2'")
    ap.add_argument("--slots", type=int, default=4,
                    help="serve-mesh mode: engine slots")
    ap.add_argument("--serve-max-len", type=int, default=None,
                    help="serve-mesh mode: engine KV length")
    ap.add_argument("--smoke", action="store_true",
                    help="serve-mesh mode: smoke-sized config")
    args = ap.parse_args(argv)

    if args.serve_mesh:
        d, m = args.serve_mesh.lower().split("x")
        rec = run_serve_cell(args.arch, mesh_shape=(int(d), int(m)),
                             slots=args.slots, max_len=args.serve_max_len,
                             smoke=args.smoke)
        print(json.dumps(rec, indent=1))
        return 0

    if args.all:
        fails = run_all(args.multi_pod, args.skip_existing)
        return 1 if fails else 0

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all, or --serve-mesh")
    flags = {}
    for kv in filter(None, args.flags.split(",")):
        k, v = kv.split("=")
        flags[k] = int(v) if v.lstrip("-").isdigit() else v

    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   flags=flags, moe_partition=args.moe_partition,
                   layout=args.layout)
    out = _cell_path(args.arch, args.shape, args.multi_pod)
    if flags or args.moe_partition != "tp" or args.layout != "2d":
        tag = ",".join(f"{k}={v}" for k, v in sorted(flags.items()))
        if args.moe_partition != "tp":
            tag += ("," if tag else "") + f"moe={args.moe_partition}"
        if args.layout != "2d":
            tag += ("," if tag else "") + f"layout={args.layout}"
        out = out.with_name(out.stem + f"__{tag}" + ".json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    r = rec["roofline"]
    print(json.dumps({
        "cell": f"{args.arch} x {args.shape}",
        "mesh": rec["mesh"]["shape"],
        "run_s": round(rec["run_seconds"], 1),
        "compute_s": r["compute_s"], "memory_s": r["memory_s"],
        "collective_s": r["collective_s"], "dominant": r["dominant"],
        "useful_flops_ratio": r["useful_flops_ratio"],
        "roofline_fraction": r["roofline_fraction"],
        "mem_per_dev_GB": (rec["memory"].get("total_nonalias_bytes", 0) or 0) / 2**30,
        "fits_hbm": rec["fits_hbm"],
        "record": str(out),
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
