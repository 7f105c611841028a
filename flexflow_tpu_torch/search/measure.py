"""Microbenchmarks on the card that calibrate the machine model
(``flexflow_tpu/search/measure.py``).

Each measurement runs a real workload on the H100 — a square GEMM per
dtype, two convolutions through cuDNN in channels-last, an elementwise
pass, a trivial launch — and records the fraction of the datasheet peak
(``MachineSpec.h100``) it reaches, into ``H100MachineModel.efficiency``.
Timing is CUDA events around a run of repeats, after a synchronize.
They measure the card or nothing: on a host without CUDA they raise.

``calibrated_machine_model`` measures once per (card name, power limit)
and keeps the factors under the kernels' git-ignored build directory
(``flexflow_tpu_torch/_build``; override with
``FLEXFLOW_TORCH_CACHE``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

from .machine_model import H100MachineModel, default_machine_model

def _cuda():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "machine-model calibration measures the card: CUDA is not "
            "available")
    return torch


def _time_ms(fn, repeats: int) -> float:
    """Mean device milliseconds of ``fn`` over ``repeats`` back-to-back
    calls, between CUDA events recorded after a warm call and a
    synchronize."""
    torch = _cuda()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def measure_matmul_efficiency(mm: H100MachineModel, n: int = 8192,
                              repeats: int = 30, dtype=None) -> float:
    """Achieved fraction of the dtype's peak (``peak_flops_for``) by an
    n x n x n GEMM (f32 with TF32 off, as the port computes)."""
    torch = _cuda()
    name = str(dtype or "bfloat16").replace("torch.", "")
    tdt = getattr(torch, name)
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.ones((n, n), dtype=tdt, device="cuda")
    b = torch.ones((n, n), dtype=tdt, device="cuda")
    out = torch.empty((n, n), dtype=tdt, device="cuda")
    ms = _time_ms(lambda: torch.matmul(a, b, out=out), repeats)
    achieved = 2.0 * n ** 3 / (ms * 1e-3)
    return min(1.0, achieved / mm.peak_flops_for(name))


def measure_conv_efficiency(mm: H100MachineModel, repeats: int = 20
                            ) -> float:
    """Achieved fraction of the bf16 peak by convolutions through
    cuDNN, channels-last bf16, over the JAX package's two
    Inception-like shapes (a 3x3 and a 1x1): the FLOP-weighted rate
    of the mix."""
    torch = _cuda()
    shapes = [
        # (batch, h, w, cin, cout, k)
        (64, 56, 56, 64, 128, 3),
        (64, 28, 28, 256, 256, 1),
    ]
    total_flops = 0.0
    total_s = 0.0
    for (b, h, w, cin, cout, k) in shapes:
        x = torch.ones((b, cin, h, w), dtype=torch.bfloat16,
                       device="cuda").to(memory_format=torch.channels_last)
        kern = torch.ones((cout, cin, k, k), dtype=torch.bfloat16,
                          device="cuda").to(
            memory_format=torch.channels_last)
        ms = _time_ms(lambda: torch.nn.functional.conv2d(
            x, kern, padding=k // 2), repeats)
        total_s += ms * 1e-3
        total_flops += 2.0 * b * h * w * cout * cin * k * k
    return min(1.0, total_flops / total_s / mm.spec.peak_flops)


def measure_elementwise_efficiency(mm: H100MachineModel, n: int = 16384,
                                   repeats: int = 100) -> float:
    """Achieved fraction of the HBM rate by one elementwise pass over an
    n x n f32 array (``a * 1.0001``: one read, one write, one kernel)."""
    torch = _cuda()
    x = torch.ones((n, n), dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    ms = _time_ms(lambda: torch.mul(x, 1.0001, out=y), repeats)
    achieved = 2.0 * x.numel() * 4 / (ms * 1e-3)
    return min(1.0, achieved / mm.spec.hbm_bandwidth)


def measure_step_overhead(repeats: int = 50) -> float:
    """Seconds one trivial launch holds the stream when the queue is
    kept full (the fixed per-dispatch cost)."""
    torch = _cuda()
    x = torch.ones((8, 8), dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    return _time_ms(lambda: torch.add(x, 1.0, out=y), repeats) * 1e-3


def calibrate(mm: H100MachineModel, save_path: Optional[str] = None
              ) -> dict:
    """Measure the card and write the factors into ``mm.efficiency``
    (``matmul`` and ``matmul:bfloat16`` from the bf16 GEMM,
    ``matmul:float32`` from the f32 one, ``conv``, ``elementwise``,
    ``step_overhead_s``). Returns the measured factors; raises without
    a card. ``save_path`` persists them (an unwritable path only
    warns)."""
    out = {}
    out["matmul"] = max(0.05, measure_matmul_efficiency(mm))
    out["matmul:float32"] = max(
        0.05, measure_matmul_efficiency(mm, dtype="float32"))
    out["matmul:bfloat16"] = out["matmul"]
    out["conv"] = max(0.05, measure_conv_efficiency(mm))
    out["elementwise"] = max(0.05, measure_elementwise_efficiency(mm))
    out["step_overhead_s"] = measure_step_overhead()
    mm.efficiency.update(out)
    if save_path:
        try:
            mm.save_calibration(save_path)
        except OSError as e:
            import warnings
            warnings.warn(f"could not persist calibration to "
                          f"{save_path}: {e}")
    return out


_CAL_MEMO: dict = {}


def card_identity() -> str:
    """The card's name and power limit (``nvidia-smi``'s
    ``name,power.limit``; the name alone when nvidia-smi is absent):
    a card set below its maximum power runs slower, so its factors are
    its own."""
    torch = _cuda()
    name = torch.cuda.get_device_name(0)
    try:
        import subprocess
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, ValueError):
        pass
    return name


def cache_file(prefix: str, identity: str) -> str:
    """Per-card measurement cache path under the kernels' build
    directory (``FLEXFLOW_TORCH_CACHE`` overrides it)."""
    root = os.environ.get("FLEXFLOW_TORCH_CACHE") or str(
        Path(__file__).resolve().parent.parent / "_build")
    safe = "".join(ch if ch.isalnum() or ch in "._-" else "_"
                   for ch in identity.lower())
    return os.path.join(root, f"{prefix}_{safe}.json")


def calibrated_machine_model(mesh=None, machine_file: Optional[str] = None,
                             force: bool = False) -> H100MachineModel:
    """``default_machine_model`` with its efficiency factors measured
    on this card, once per card identity (name and power limit):
    memoized in-process and kept on disk (:func:`cache_file`). Raises
    without a card."""
    mm = default_machine_model(mesh, machine_file=machine_file)
    ident = card_identity()
    if not force and ident in _CAL_MEMO:
        mm.efficiency.update(_CAL_MEMO[ident])
        return mm
    path = cache_file("calibration", ident)
    if not force and os.path.exists(path):
        try:
            mm.load_calibration(path)
            _CAL_MEMO[ident] = dict(mm.efficiency)
            return mm
        except (OSError, json.JSONDecodeError):
            pass
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
    except OSError:
        path = None
    calibrate(mm, save_path=path)
    _CAL_MEMO[ident] = dict(mm.efficiency)
    return mm
