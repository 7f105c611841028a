"""A tiny copy of the benchmark for the CPU tests.

``make(tmp)`` lays out a benchmark directory under ``tmp``: the real
``metrics/`` readers, tiny OPT configurations with the real ones'
program settings scaled down, tiny mixes, and a ``BENCHMARK.json`` that
gives the tiny cells the real cells' metrics. ``run(...)`` runs one of
its cells on the CPU through the harness, past its look for a chip.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

BASE = Path(__file__).resolve().parent.parent
ROOT = BASE.parent

MODEL = {"hidden_size": 64, "num_hidden_layers": 2,
         "num_attention_heads": 4, "ffn_dim": 128, "vocab_size": 512,
         "max_position_embeddings": 128}

CELLS = {
    "tiny-serve": ("serve-long-context", "tiny-serve", "tiny-loop"),
    "tiny-train": ("train-seq2048", "tiny-train", "tiny-steps"),
}


def make(tmp: Path) -> Path:
    base = Path(tmp) / "bench"
    shutil.copytree(BASE / "metrics", base / "metrics")
    for d in ("configs", "traffic", "workloads"):
        (base / d).mkdir(parents=True)
    serve = json.loads((BASE / "configs/opt-1.3b-serve.json").read_text())
    serve.update(MODEL)
    serve["program"].update(kv_num_pages=65, serve_max_seqs=4,
                            serve_prefill_budget=32)
    train = json.loads((BASE / "configs/opt-1.3b-train.json").read_text())
    train.update(MODEL)
    train["optimizer"]["lr"] = 1e-3
    files = {
        "configs/tiny-serve.json": serve,
        "configs/tiny-train.json": train,
        "traffic/tiny-loop.json": {
            "kind": "closed_loop", "clients": 4,
            "prompt": {"min": 20, "max": 60, "median": 28},
            "output": {"min": 4, "max": 16, "median": 7}, "pareto_a": 2.0,
            "pool": 512, "sizes_seed": 27, "ramp_steps": 6,
            "trace_seconds": 1, "check_tokens": 200},
        "traffic/tiny-steps.json": {
            "kind": "train_steps", "batch": 4,
            "seq": MODEL["max_position_embeddings"], "steps_per_call": 2,
            "trace_calls": 1},
        "workloads/tiny-serve.json": {
            "config": "tiny-serve", "traffic": "tiny-loop", "chips": 1,
            "why": "tiny", "limits": {"served_logit_gap": 0.006}},
        "workloads/tiny-train.json": {
            "config": "tiny-train", "traffic": "tiny-steps", "chips": 1,
            "why": "tiny", "limits": {"loss_gap": 1e-3, "grad_norm_gap": 0.02,
                                      "update_norm_gap": 0.05}},
    }
    for rel, obj in files.items():
        (base / rel).write_text(json.dumps(obj))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for rows in (bench["end_to_end"], bench["per_layer"]):
        for m in rows:
            if "workloads" in m:
                m["workloads"] = [t for t, (real, _, _) in CELLS.items()
                                  if real in m["workloads"]]
    (Path(tmp) / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


def run(base: Path, cell: str, seed: int = 3, seconds: float = 1.0,
        trace: bool = False):
    from portbench.harness.cells import run_cell
    from portbench.harness.registry import Registry
    reg = Registry(base)
    cache = Path(base) / ".cache" / "programs"
    cache.mkdir(parents=True, exist_ok=True)
    return run_cell(reg, cell, seed, seconds, trace, "cpu",
                    time.perf_counter(), cache)
