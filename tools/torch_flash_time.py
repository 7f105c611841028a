"""Time the flash kernels of the checkout this file sits in, at the
encoder's training shapes (b=32, s=512, h=8, d=64, not causal; bf16 and
f32), through their public wrappers, in two ways:

- ``device``: a spin kernel holds the stream while the host enqueues the
  call, so the CUDA events around it see the kernels alone;
- ``with_host``: the call is enqueued while the card idles, so the
  wrapper's host time shows wherever it outlasts the L2 flush before it.

The L2 is evicted before each call. Each way is timed in 3 rounds of 20
calls, interleaved; prints the card, each kernel's error against its
plain piece, and one JSON line of medians (ms) and rounds. Needs one
NVIDIA GPU.

    python3 tools/torch_flash_time.py [--label NAME]

To compare two checkouts on one card, copy this file into the other
checkout's ``tools/`` and run both in one call, in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu_torch.kernels import flash_attention as fa  # noqa: E402

B, S, H, D = 32, 512, 8, 64
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}   # chip_smoke.py's
SPIN_CYCLES = 2_000_000      # ~1 ms at H100 clocks: longer than a launch


def timed(fn, device_only: bool, iters: int = 20) -> float:
    """Mean ms of fn() between CUDA events, after 3 warm-up calls."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=str(ROOT.name))
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip(), flush=True)
    dev = torch.device("cuda")
    out = {"label": args.label}
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        rng = np.random.default_rng(11)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (B, S, H, D), np.float32)).to(dev).to(dtype) for _ in range(4))
        kw = {"causal": False, "scale": 1.0 / np.sqrt(D)}
        o, lse = fa.flash_fwd_ref(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        bargs = (q, k, v, do, lse, delta)
        fns = {
            "flash_fwd": (lambda: fa.flash_fwd_cuda(q, k, v, **kw),
                          lambda: (o,)),
            "flash_bwd_dq": (lambda: (fa.flash_bwd_dq_cuda(*bargs, **kw),),
                             lambda: (fa.flash_bwd_dq_ref(*bargs, **kw),)),
            "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv_cuda(*bargs, **kw),
                              lambda: fa.flash_bwd_dkv_ref(*bargs, **kw))}
        for name, (cuda_fn, ref_fn) in fns.items():
            got, want = cuda_fn(), ref_fn()
            rel = max(float((a.float() - r.float()).abs().max()
                            / r.float().abs().max())
                      for a, r in zip(got, want))
            print(f"{args.label} {name} {dname}: error / max |plain| "
                  f"{rel:.3g} (tol {TOL[dtype]})", flush=True)
            if not rel <= TOL[dtype]:
                raise AssertionError(f"{name} {dname} is wrong: {rel}")
        rounds = {(n, way): [] for n in fns for way in ("device",
                                                         "with_host")}
        keys = list(rounds)
        for r in range(3):
            for n, way in (keys if r % 2 == 0 else keys[::-1]):
                rounds[n, way].append(timed(fns[n][0], way == "device"))
        for (n, way), xs in rounds.items():
            out[f"{n} {dname} {way}"] = {"ms": statistics.median(xs),
                                         "rounds": xs}
        del q, k, v, do, o, lse, delta, bargs, fns
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
