"""Where a serving step of the PyTorch/CUDA port spends its time.

    python3 tools/torch_serve_profile.py [--kv-dtype int8] [--legacy]
        [--modes captured,eager] [--out PATH]

Serves chip_smoke.py's full-width LM (``build_transformer_lm``, weights
from the config's seed) and its 8 greedy prompts on the card, for each
of ``--modes`` in turn — ``captured`` (the engine's default: every step
replays the graph ``warmup`` captured) and ``eager`` (capture off):
three times plain (wall time per step with decodes — host times vary
between runs, so all three are printed) and once under
``torch.profiler`` (CPU + CUDA activities), then prints device time by
kernel class — the paged attention kernels, matmuls, top-k, the K/V
page scatter, copies, the rest (quantize-on-write lands there) — with
each class's share of the profiled wall time, and the device's idle
share. ``--kv-dtype`` picks the page format (float32, bfloat16, int8,
float8_e4m3), ``--legacy`` the legacy bucket path. Needs one NVIDIA
GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent

# kernel-name patterns per class, first match wins
CLASSES = (
    ("attention", re.compile(r"ragged_v2_\w*kernel|paged_decode_\w*kernel")),
    ("matmul", re.compile(r"gemm|matmul|sm90_|cutlass|cublas", re.I)),
    ("topk", re.compile(r"topk|sort|radix|argmax|reduce_kernel.*max",
                        re.I)),
    ("kv_scatter", re.compile(r"index_put|indexing|scatter", re.I)),
    ("copy", re.compile(r"memcpy|memset|copy", re.I)),
)


def classify(name: str) -> str:
    for cls, pat in CLASSES:
        if pat.search(name):
            return cls
    return "other"


def profile(eng, greedy):
    """One engine's numbers: plain runs, then a profiled one."""
    eng.warmup()
    eng.generate(greedy, 32)                 # warm every code path
    eng.cache.clear_prefix()                 # same prefix state each run
    plain = []
    for _ in range(3):
        eng.generate(greedy, 32)
        plain.append(eng.last_stats)
        eng.cache.clear_prefix()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.generate(greedy, 32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = eng.last_stats["steps"]
    by_cls = {}
    by_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue     # operator rows re-count their kernels' time
        dev_us = float(evt.self_device_time_total)
        if dev_us <= 0:
            continue
        by_cls[classify(evt.key)] = by_cls.get(classify(evt.key), 0.0) \
            + dev_us
        by_kernel[evt.key] = (dev_us, evt.count)
    busy_s = sum(by_cls.values()) / 1e6
    if busy_s <= 0:
        raise RuntimeError("the profiler saw no device time")
    return {
        "mode": eng.last_stats["mode"],
        "steps": steps,
        "captures": eng.compile_counts(),
        "plain_wall_s": [p["wall_s"] for p in plain],
        "plain_step_ms_mean": [1e3 * float(np.mean(p["decode_step_times_s"]))
                               for p in plain],
        "plain_tokens_per_s": [p["tokens_per_sec"] for p in plain],
        "profiled_wall_s": wall,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall,
        "device_ms_per_step": {k: v / 1e3 / steps
                               for k, v in sorted(by_cls.items())},
        "share_of_wall": {k: v / 1e6 / wall
                          for k, v in sorted(by_cls.items())},
        "top_kernels": [
            {"name": k[:120], "device_ms": v[0] / 1e3, "count": v[1]}
            for k, v in sorted(by_kernel.items(),
                               key=lambda kv: -kv[1][0])[:12]],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv-dtype", default="float32")
    ap.add_argument("--legacy", action="store_true")
    ap.add_argument("--modes", default="captured,eager")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import serve_prompts
    from flexflow_tpu_torch import FFConfig, build_transformer_lm
    from flexflow_tpu_torch.serve import ServeEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    cfg = FFConfig(kv_dtype=args.kv_dtype,
                   serve_chunked_prefill=not args.legacy)
    lm = build_transformer_lm(cfg, vocab_size=32000, max_seq_len=512,
                              hidden=512, num_heads=8, num_layers=6,
                              ff_dim=2048, device="cuda")
    greedy, _ = serve_prompts(32000)
    res = {"card": card, "kv_dtype": args.kv_dtype, "modes": {}}
    for mode in args.modes.split(","):
        eng = ServeEngine(lm, cfg, capture=mode == "captured")
        cell = res["modes"][mode] = profile(eng, greedy)
        res["mode"] = cell["mode"]
        print(f"[{card}] {cell['mode']} {args.kv_dtype} pages, {mode}: "
              f"steps={cell['steps']} plain wall s "
              f"{[round(w, 4) for w in cell['plain_wall_s']]}, step ms mean "
              f"{[round(m, 3) for m in cell['plain_step_ms_mean']]}; "
              f"profiled wall {cell['profiled_wall_s']:.4f} s, device busy "
              f"{cell['device_busy_s']:.4f} s, idle share "
              f"{cell['device_idle_share']:.3f}; captures "
              f"{cell['captures']}")
        for k, v in cell["device_ms_per_step"].items():
            print(f"  {k:11s} {v:8.4f} device ms/step  "
                  f"{cell['share_of_wall'][k]:.3f} of wall")
        for row in cell["top_kernels"]:
            print(f"  {row['device_ms']:9.3f} ms x{row['count']:<5d} "
                  f"{row['name']}")
        eng.close()
        del eng
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"ok": True, "device_idle_share": {
        m: c["device_idle_share"] for m, c in res["modes"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
