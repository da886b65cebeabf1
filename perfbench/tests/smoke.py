"""A checkout of the benchmark at smoke sizes, for the CPU tests: the
real harness under ``perfbench/``, with ``BENCHMARK.json``, configurations
and mixes of its own in a temporary root."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

CONFIGS = {
    "granite-smoke": {
        "name": "granite-smoke", "arch": "granite-moe-3b-a800m",
        "smoke": True, "family": "moe", "num_hidden_layers": 2,
        "hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "num_local_experts": 8,
        "num_experts_per_tok": 4, "intermediate_size": 32,
        "vocab_size": 512, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "tie_word_embeddings": True, "capacity_factor": 1.25,
        "flags": {"attn_impl": "pallas", "norm_impl": "pallas",
                  "moe_impl": "gmm", "ssm_impl": "pallas"},
        "serve": {"slots": 4, "max_len": 256, "lease_ttl_s": 3.0}},
    "mamba2-smoke": {
        "name": "mamba2-smoke", "arch": "mamba2-370m", "smoke": True,
        "family": "ssm", "num_hidden_layers": 2, "hidden_size": 64,
        "state_size": 16, "head_dim": 16, "expand": 2, "conv_kernel": 4,
        "chunk_size": 32, "n_groups": 1, "vocab_size": 512,
        "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
        "flags": {"attn_impl": "pallas", "norm_impl": "pallas",
                  "moe_impl": "gmm", "ssm_impl": "pallas"},
        "serve": {"slots": 4, "max_len": 256, "lease_ttl_s": 3.0},
        "train": {"batch": 2, "seq": 64, "optimizer": {
            "peak_lr": 3e-4, "min_lr_ratio": 0.1, "warmup_steps": 100,
            "total_steps": 1000, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
            "weight_decay": 0.1, "clip_norm": 1.0}}},
}

TRAIN = {"name": "tinytrain", "kind": "train", "warmup_steps": 4,
         "compared_steps": 3, "profile_steps": 2}

MIX = {"name": "tiny", "kind": "closed_loop", "clients": 4,
       "prompt_tokens": {"dist": "log_normal", "median": 28, "sigma": 0.6,
                         "low": 8, "high": 100},
       "output_tokens": {"dist": "log_normal", "median": 16, "sigma": 0.4,
                         "low": 8, "high": 32},
       "warmup_s": 0.3, "drain_s": 60.0, "profile_s": 0.3,
       "check_requests": 6}


TRAIN_LIMITS = {"loss_gap": 1.5e-4, "grad_gap": 0.005, "change_gap": 0.01}

# the train kind's metrics, which BENCHMARK.json lists for no cell yet
TRAIN_METRICS = {
    "end_to_end": [{"name": "train_tokens_per_s", "unit": "tokens/s",
                    "better": "higher", "bound": 0.01,
                    "source": "host_clock"}],
    "per_layer": [
        {"name": "train_step_ms.p50", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "train step",
         "moves": "train_tokens_per_s"},
        {"name": "train_mfu_pct", "unit": "%", "better": "higher",
         "source": "host_clock", "layer": "model step",
         "moves": "train_tokens_per_s"},
        {"name": "device_idle_pct.train", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "train_tokens_per_s"}],
}


def checkout(root: Path, limits: dict | None = None) -> Path:
    """Write a smoke checkout under ``root``: the harness copied whole,
    two smoke configurations, the ``tiny`` serve mix and a cell of each
    configuration under it, the ``tinytrain`` mix and a train cell of the
    SSM configuration, and ``limits`` for the serve cells (with
    `TRAIN_LIMITS` for the train cell; None: no limits files)."""
    shutil.copytree(HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for name, c in CONFIGS.items():
        path = f"perfbench/configs/{name}.json"
        (root / path).write_text(json.dumps(c))
        bench["configs"].append({"name": name, "source": "smoke",
                                 "file": path, "reduced": [], "why": "test"})
        cell = f"{name}.tiny"
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "test"})
        if limits is not None:
            (root / "perfbench" / "limits" / f"{cell}.json").write_text(
                json.dumps({"limits": limits}))
    bench["workloads"].append({"name": "mamba2-smoke.tinytrain",
                               "config": "mamba2-smoke",
                               "traffic": "tinytrain", "chips": 1,
                               "why": "test"})
    if limits is not None:
        (root / "perfbench" / "limits" / "mamba2-smoke.tinytrain.json"
         ).write_text(json.dumps({"limits": TRAIN_LIMITS}))
    serve = [w["name"] for w in bench["workloads"][:-1]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = serve
    for kind, metrics in TRAIN_METRICS.items():
        bench[kind] += [dict(m, workloads=["mamba2-smoke.tinytrain"])
                        for m in metrics]
    (root / "perfbench" / "traffic" / "tiny.json").write_text(json.dumps(MIX))
    (root / "perfbench" / "traffic" / "tinytrain.json").write_text(
        json.dumps(TRAIN))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
