"""Where a training step of the PyTorch/CUDA port spends its time.

    python3 tools/torch_train_profile.py [--model transformer|transformer_lm|nmt_lstm|
        alexnet|inception|resnet50|candle_uno|seq2seq]
        [--modes captured,eager] [--steps 10] [--feed train_batch|fit|prefetch]
        [--out PATH]

Trains one of chip_smoke.py's bf16 models on the card: the flagship
(``--model transformer``, the default: ``build_transformer`` at batch 32,
seq 512, hidden 512, 8 heads, 6 layers, ff 2048, 10 classes), the causal
LM (``--model transformer_lm``: ``build_transformer_lm`` at vocab 32000,
512 positions, hidden 512, 8 heads, 6 layers, ff 2048, batch 16 x 512
tokens, compute_dtype bfloat16 over f32 masters, momentum 0.9) or the
NMT LSTM (``--model nmt_lstm``: ``build_nmt_lstm`` at bench.py's full
preset, batch 256, seq 40, vocab 32000, embed and hidden 1024, 2
layers), or one of the sweep's models at chip_smoke.py's widths
(``SWEEP``: AlexNet at batch 256 on 3x32x32, Inception-v3 at batch 32
on 3x299x299 and ResNet-50 at batch 32 on 3x224x224 in bf16,
CANDLE-Uno at batch 64 in f32, the seq2seq at batch 64 in bf16; cuDNN
deterministic and without autotuning, as the smoke runs them), SGD lr
0.01, weights and data from numpy seeds. For each of
``--modes`` — ``captured`` (every step after the first replays the
train step's CUDA graph, the default path) and ``eager`` (capture off)
— in turn: 3 warm-up steps, three plain windows of ``--steps`` steps
(wall time per step — host times vary between runs, so all three are
printed), then one window under ``torch.profiler`` (CPU + CUDA
activities). Prints device time per step
by kernel class — the hand-written kernels (flash attention or LSTM),
convolutions (cuDNN), pooling, reductions (BatchNorm's statistics in the
conv models), elementwise passes (BatchNorm's normalization with ReLU,
residual adds, casts), matmuls, copies, the rest — with each class's
share of the profiled wall time, and the device's idle share; for the NMT model also the idle
time between the LSTM kernels' consecutive step launches.
``--feed`` chooses how a window's steps get their batches: one
``train_batch`` call a host batch (the default), or one epoch of
``fit`` over ``--steps`` batches without a shuffle — its batches copied
from pageable numpy each step (``fit``) or staged by the prefetching
loader through pinned buffers on a copy stream (``prefetch``). Needs
one NVIDIA GPU.
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
    ("attention_fwd", re.compile(r"flash_fwd_(mma_)?kernel")),
    ("attention_bwd_dq", re.compile(r"flash_bwd_dq_(mma_)?kernel")),
    ("attention_bwd_dkv", re.compile(r"flash_bwd_dkv_(mma_)?kernel")),
    ("lstm_fwd", re.compile(r"lstm_fwd_step_(mma_)?kernel")),
    ("lstm_bwd", re.compile(r"lstm_bwd_step_(mma_)?kernel|"
                            r"lstm_dh0_(mma_)?kernel")),
    ("lstm_dwh", re.compile(r"lstm_dwh_(mma_)?kernel")),
    # cuDNN's convolution kernels and its layout transforms
    ("conv", re.compile(r"conv|fprop|dgrad|wgrad|cudnn|winograd|"
                        r"implicit_gemm|nchwToNhwc|nhwcToNchw", re.I)),
    ("pool", re.compile(r"pool", re.I)),
    ("reduce", re.compile(r"reduce_kernel|reduction", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized", re.I)),
    # cuBLAS names its Hopper GEMMs nvjet_*
    ("matmul", re.compile(r"gemm|matmul|nvjet|sm90_|cutlass|cublas",
                          re.I)),
    ("copy", re.compile(r"memcpy|memset|copy", re.I)),
)


def classify(name: str) -> str:
    for cls, pat in CLASSES:
        if pat.search(name):
            return cls
    return "other"


def launch_gaps(prof, classes):
    """Idle device time between two consecutive kernels that both fall
    in `classes` (a kernel ends, the next of the same sequence starts):
    (total gap us, number of gaps), from the trace's kernel timestamps.
    For the LSTM's one-launch-a-step kernels this is the price of a
    launch a step that a persistent launch would save."""
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    total, n = 0.0, 0
    for a, b in zip(kernels, kernels[1:]):
        if classify(a.key) in classes and classify(b.key) in classes:
            total += max(0.0, b.time_range.start - a.time_range.end)
            n += 1
    return total, n


def build(cs, model, capture):
    """(model, its batches, samples a step, tokens a step)."""
    if model in cs.SWEEP:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        batch, route = cs.SWEEP[model][2], cs.SWEEP[model][3]
        dtype = torch.float32 if route is None else torch.bfloat16
        tokens = batch * 20 if model == "seq2seq" else batch
        return (cs.sweep_model(model, batch, dtype, capture=capture),
                cs.sweep_batches(model, batch, 4), batch, tokens)
    if model == "nmt_lstm":
        return (cs.nmt_model(torch.bfloat16, None, capture),
                cs.nmt_batches(4), cs.NB, cs.NB * cs.NT)
    if model == "transformer_lm":
        return (cs.lm_model("bfloat16", capture=capture), cs.lm_batches(4),
                cs.LB, cs.LB * cs.TS)
    return (cs.train_model(torch.bfloat16, None, capture),
            cs.train_batches(4), cs.TB, cs.TB * cs.TS)


def feed_arrays(batches, steps):
    """fit's arrays for ``steps`` batches, cycling the given ones."""
    keys = [k for k in batches[0] if k != "label"]
    pick = [batches[i % len(batches)] for i in range(steps)]
    x = {k: np.concatenate([b[k] for b in pick]) for k in keys}
    return x, np.concatenate([b["label"] for b in pick])


def profile(cs, args, capture):
    """One mode's numbers: plain windows, then a profiled one."""
    m, batches, batch, tokens = build(cs, args.model, capture)
    for i in range(3):                      # warm every code path
        m.train_batch(batches[i])

    def window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = [m.train_batch(batches[i % len(batches)])
              for i in range(args.steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return wall, [float(x["loss"]) for x in ms]

    if args.feed != "train_batch":
        x, y = feed_arrays(batches, args.steps)

        def window():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist = m.fit(x, y, batch_size=batch, epochs=1, verbose=False,
                         shuffle=False, prefetch=args.feed == "prefetch")
            torch.cuda.synchronize()
            return time.perf_counter() - t0, [h["loss"] for h in hist]

        window()                            # the fit path's own warm-up
    plain = [window()[0] for _ in range(3)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, _ = window()
    by_cls, by_kernel = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue     # operator rows re-count their kernels' time
        dev_us = float(evt.self_device_time_total)
        if dev_us <= 0:
            continue
        cls = classify(evt.key)
        by_cls[cls] = by_cls.get(cls, 0.0) + dev_us
        by_kernel[evt.key] = (dev_us, evt.count)
    busy_s = sum(by_cls.values()) / 1e6
    if busy_s <= 0:
        raise RuntimeError("the profiler saw no device time")
    steps = args.steps
    gaps = {}
    if args.model == "nmt_lstm":
        for name, classes in (("lstm_fwd", ("lstm_fwd",)),
                              ("lstm_bwd", ("lstm_bwd", "lstm_dwh"))):
            gap_us, n = launch_gaps(prof, classes)
            dev_us = sum(by_cls.get(c, 0.0) for c in classes)
            gaps[name] = {"gap_ms_per_step": gap_us / 1e3 / steps,
                          "gaps": n, "mean_gap_us": gap_us / max(n, 1),
                          "gap_share": gap_us / (gap_us + dev_us)}
    own = sum(v for k, v in by_cls.items()
              if k.startswith(("attention", "lstm")))
    out = {
        "captures": m.compile_counts(),
        "replays": m.executor.programs.replay_counts(),
        "plain_step_ms": [1e3 * w / steps for w in plain],
        "plain_samples_per_s": [batch * steps / w for w in plain],
        "plain_tokens_per_s": [tokens * steps / w for w in plain],
        "profiled_wall_s": wall,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall,
        "handwritten_share_of_device": own / 1e6 / busy_s,
        "device_ms_per_step": {k: v / 1e3 / steps
                               for k, v in sorted(by_cls.items())},
        "share_of_wall": {k: v / 1e6 / wall
                          for k, v in sorted(by_cls.items())},
        "launch_gaps": gaps,
        "top_kernels": [
            {"name": k[:120], "device_ms": v[0] / 1e3, "count": v[1]}
            for k, v in sorted(by_kernel.items(),
                               key=lambda kv: -kv[1][0])[:12]],
    }
    m.executor.programs.release()
    del m
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("transformer", "transformer_lm",
                                        "nmt_lstm", "alexnet", "inception",
                                        "resnet50", "candle_uno",
                                        "seq2seq"),
                    default="transformer")
    ap.add_argument("--modes", default="captured,eager")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--feed", choices=("train_batch", "fit", "prefetch"),
                    default="train_batch")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    res = {"card": card, "model": args.model, "steps": args.steps,
           "feed": args.feed, "modes": {}}
    for mode in args.modes.split(","):
        res["modes"][mode] = profile(cs, args, mode == "captured")
        cell = res["modes"][mode]
        print(f"[{card}] {args.model} {mode} ({args.feed}), {args.steps} "
              f"steps a window; "
              f"plain step ms {[round(x, 3) for x in cell['plain_step_ms']]}"
              f", samples/s "
              f"{[round(x, 1) for x in cell['plain_samples_per_s']]}; "
              f"profiled wall {cell['profiled_wall_s']:.4f} s, device busy "
              f"{cell['device_busy_s']:.4f} s, idle share "
              f"{cell['device_idle_share']:.3f}, hand-written kernels "
              f"{cell['handwritten_share_of_device']:.3f} of device time")
        for k, v in cell["device_ms_per_step"].items():
            print(f"  {k:17s} {v:9.4f} device ms/step  "
                  f"{cell['share_of_wall'][k]:.3f} of wall")
        for k, g in cell["launch_gaps"].items():
            print(f"  {k} launch gaps: {g['gap_ms_per_step']:.4f} ms/step "
                  f"over {g['gaps']} gaps (mean {g['mean_gap_us']:.2f} us), "
                  f"{g['gap_share']:.3f} of the kernel's device time + gaps")
        for row in cell["top_kernels"]:
            print(f"  {row['device_ms']:9.3f} ms x{row['count']:<5d} "
                  f"{row['name']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"ok": True, "device_idle_share": {
        m: c["device_idle_share"] for m, c in res["modes"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
