"""Time kernels of the checkout this file sits in, device-only, at
``chip_smoke.py``'s shapes and on its inputs:

- kernel 1 (ragged paged attention v2) on f32, bf16, int8 and fp8
  pages over the mixed step's 520 lanes (a 512-lane prefill chunk on
  one slot plus 8 decode lanes), in the step's lane order and with the
  lanes shuffled;
- kernels 5 and 6 (paged decode, v1) on f32 and bf16 pages: the decode
  kernel at the legacy decode step's 8 rows (lengths 1..512) and at
  ``chip_smoke.DECODE_SHAPES`` (one row of 512 keys; 8 rows of 4096),
  v1 at the mixed step's 520 lanes, each beside its bound;
- kernel 7 (LSTM forward) in bf16 and f32 at T=40, B=256, H=1024.

Each call starts with the L2 evicted and a spin kernel holding the
stream while the host enqueues it, so the CUDA events see device work
only. Each kernel is timed in 3 rounds of 20 calls, interleaved, beside
the timer's floor (a one-element fill timed the same way); prints the
card, each kernel's error against its plain version, and one JSON line
of medians (ms), rounds and bounds. Needs one NVIDIA GPU.

    python3 tools/torch_kernel_time.py [--label NAME] [--only PREFIX ...]

To compare two checkouts on one card, copy this file and
``chip_smoke.py`` into the other checkout and run both in one call, in
the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from flexflow_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from flexflow_tpu_torch.kernels import lstm_scan as ls  # noqa: E402
from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr  # noqa: E402


def attention_fns(dev):
    """{name: (kernel call, error against the plain version, bound ms)}
    for kernel 1 on the four page types, in step order and shuffled."""
    scale = 1.0 / math.sqrt(cs.HEAD_DIM)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(
        cs.T_PREFILL + cs.MAX_SEQS)).to(dev)
    fns = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("int8", torch.int8),
                        ("fp8", torch.float8_e4m3fn)):
        quant = dtype in pr.QUANTIZED_DTYPES
        q, kp, vp, tables, slots, lens = cs.kernel_inputs(
            torch.float32 if quant else dtype, dev)
        kw = {}
        if quant:
            kp, ks = pr.quantize_kv_rows(kp, dtype)
            vp, vs = pr.quantize_kv_rows(vp, dtype)
            kw = {"k_scales": ks, "v_scales": vs}
        for order, idx in (("", None), (" shuffled", perm)):
            args = (q, kp, vp, tables, slots, lens) if idx is None else (
                q[idx].contiguous(), kp, vp, tables, slots[idx].contiguous(),
                lens[idx].contiguous())
            call = (lambda a=args, k=kw:
                    pr.paged_ragged_v2_cuda(*a, scale, **k))
            out = call()
            ref = pr.ragged_attention_ref(*args, scale, **kw)
            fns[f"paged_ragged_v2 {name}{order}"] = (
                call, float((out.float() - ref.float()).abs().max()),
                cs.attention_bound(args[0], args[1], *args[3:])[0])
    return fns


def decode_fns(dev):
    """{name: (kernel call, max abs error, bound ms)} for kernels 5 and
    6 on f32 and bf16 pages: the legacy decode step's rows, the decode
    kernel at DECODE_SHAPES, v1 at the mixed step's lanes."""
    scale = 1.0 / math.sqrt(cs.HEAD_DIM)
    fns = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, kp, vp, tables, slots, lens = cs.kernel_inputs(dtype, dev)
        cells = [("paged_decode B=8 step", fa.paged_decode_cuda,
                  fa.paged_decode_ref, None,
                  (q[cs.T_PREFILL:].contiguous(), kp, vp, tables,
                   lens[cs.T_PREFILL:].contiguous())),
                 ("paged_ragged_v1 T=520", fa.paged_ragged_v1_cuda,
                  fa.paged_ragged_v1_ref, slots,
                  (q, kp, vp, tables, slots, lens))]
        cells += [(f"paged_decode {sname}", fa.paged_decode_cuda,
                   fa.paged_decode_ref, None,
                   cs.decode_inputs(dtype, dev, rows, pp))
                  for sname, rows, pp in cs.DECODE_SHAPES]
        for cname, kernel, plain, slots_of, args in cells:
            call = (lambda f=kernel, a=args: f(*a, scale))
            err = float((call().float() - plain(*args, scale).float())
                        .abs().max())
            b_ms, _ = cs.attention_bound(args[0], args[1], args[3],
                                         slots_of, args[-1])
            fns[f"{cname} {name}"] = (call, err, b_ms)
    return fns


def lstm_fns():
    """{name: (kernel call, error / max |plain|, bound ms)} for kernel
    7."""
    fns = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        xg, wh, h0, c0, _ = cs.lstm_inputs(dtype)
        call = (lambda a=(xg, wh, h0, c0): ls.lstm_fwd_cuda(*a))
        ys = call()[0]
        ref = ls.lstm_fwd_ref(xg, wh, h0, c0)[0]
        fns[f"lstm_fwd {name}"] = (call, float(
            (ys.float() - ref.float()).abs().max() / ref.float().abs().max()),
            cs.lstm_bounds(dtype)["lstm_fwd"][0])
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=str(ROOT.name))
    ap.add_argument("--only", nargs="*", default=None,
                    help="time only the kernels whose names start so "
                         "(e.g. paged_decode paged_ragged_v1)")
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip(), flush=True)
    from flexflow_tpu_torch import resolve_device
    dev = resolve_device("cuda")          # TF32 off for the plain versions
    want = lambda group: args.only is None or any(   # noqa: E731
        o.startswith(group) or group.startswith(o) for o in args.only)
    fns = {}
    for group, make in (("paged_ragged_v2", lambda: attention_fns(dev)),
                        ("paged_", lambda: decode_fns(dev)),
                        ("lstm_fwd", lstm_fns)):
        if want(group):
            fns.update(make())
    if args.only is not None:
        fns = {n: f for n, f in fns.items()
               if any(n.startswith(o) for o in args.only)}
    # the timer's floor: the least device work, timed the same way
    one = torch.zeros(1, device=dev)
    fns["floor: fill of one element"] = (lambda: one.fill_(1.0), 0.0, 0.0)
    torch.cuda.synchronize()
    for name, (_, err, _) in fns.items():
        print(f"{args.label} {name}: max abs error (lstm: / max |plain|) "
              f"{err:.3g}", flush=True)
    rounds = {n: [] for n in fns}
    keys = list(rounds)
    for r in range(3):
        for n in (keys if r % 2 == 0 else keys[::-1]):
            rounds[n].append(cs.cuda_ms(fns[n][0], 20))
    out = {"label": args.label}
    out.update({n: {"ms": statistics.median(xs), "rounds": xs,
                    "error": fns[n][1], "bound_ms": fns[n][2]}
                for n, xs in rounds.items()})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
