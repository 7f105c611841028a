"""One run of one cell: set up, measure, judge, and the result line."""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from .record import Run
from .registry import Registry

# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "flexflow_tpu")


def forbidden_modules(modules=None) -> list:
    """The names of ``FORBIDDEN`` among the top-level names (before the
    first dot) of ``modules`` (``sys.modules`` when None), compared
    whole: ``flexflow_tpu_torch`` is not ``flexflow_tpu``."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops & set(FORBIDDEN))


def run_cell(reg: Registry, cell: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, cache_dir: Path,
             chips: int = 1) -> dict:
    """Run ``cell`` once on ``device``; returns the result object (the
    contract's keys, the compared numbers last under ``checks``)."""
    from .serve_cell import run_serve
    from .train_cell import run_train

    wl, config, mix = reg.cell(cell)
    run = Run(cell, wl, config, mix)
    drive = {"serve": run_serve, "train": run_train}[run.kind]
    facts = drive(run, device, int(seed), float(seconds), bool(trace),
                  t_start, str(cache_dir))
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"),
            "count": int(chips),
            "memory_peak_bytes": facts["memory_peak_bytes"]}
    out = {"correct": all(c["value"] is not None
                          and c["value"] <= c["limit"]
                          for c in run.checks.values()),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": reg.read_metrics(cell, trace, run),
           "device": info}
    if trace and run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in run.checks.items()}
    out["_run"] = run
    return out
