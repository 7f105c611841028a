"""Time the ragged paged-attention kernel (kernel 1) and the LSTM forward
(kernel 7) of the checkout this file sits in, device-only, at
``chip_smoke.py``'s shapes and on its inputs:

- kernel 1 on f32, bf16, int8 and fp8 pages over the mixed step's 520
  lanes (a 512-lane prefill chunk on one slot plus 8 decode lanes), in
  the step's lane order and with the lanes shuffled;
- kernel 7 in bf16 and f32 at T=40, B=256, H=1024.

Each call starts with the L2 evicted and a spin kernel holding the
stream while the host enqueues it, so the CUDA events see device work
only. Each kernel is timed in 3 rounds of 20 calls, interleaved; prints
the card, each kernel's error against its plain version, and one JSON
line of medians (ms) and rounds. Needs one NVIDIA GPU.

    python3 tools/torch_kernel_time.py [--label NAME]

To compare two checkouts on one card, copy this file into the other
checkout's ``tools/`` and run both in one call, in the order A, B, B, A.
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
from flexflow_tpu_torch.kernels import lstm_scan as ls  # noqa: E402
from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr  # noqa: E402


def attention_fns(dev):
    """{name: (kernel call, error against the plain version)} for kernel
    1 on the four page types, in step order and shuffled."""
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
                call, float((out.float() - ref.float()).abs().max()))
    return fns


def lstm_fns():
    """{name: (kernel call, error / max |plain|)} for kernel 7."""
    fns = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        xg, wh, h0, c0, _ = cs.lstm_inputs(dtype)
        call = (lambda a=(xg, wh, h0, c0): ls.lstm_fwd_cuda(*a))
        ys = call()[0]
        ref = ls.lstm_fwd_ref(xg, wh, h0, c0)[0]
        fns[f"lstm_fwd {name}"] = (call, float(
            (ys.float() - ref.float()).abs().max() / ref.float().abs().max()))
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=str(ROOT.name))
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip(), flush=True)
    from flexflow_tpu_torch import resolve_device
    dev = resolve_device("cuda")          # TF32 off for the plain versions
    fns = {**attention_fns(dev), **lstm_fns()}
    torch.cuda.synchronize()
    for name, (_, err) in fns.items():
        print(f"{args.label} {name}: max abs error (lstm: / max |plain|) "
              f"{err:.3g}", flush=True)
    rounds = {n: [] for n in fns}
    keys = list(rounds)
    for r in range(3):
        for n in (keys if r % 2 == 0 else keys[::-1]):
            rounds[n].append(cs.cuda_ms(fns[n][0], 20))
    out = {"label": args.label}
    out.update({n: {"ms": statistics.median(xs), "rounds": xs,
                    "error": fns[n][1]} for n, xs in rounds.items()})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
