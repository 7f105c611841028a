"""The readings that the limits of ``correct`` are set from.

    python3 portbench/sweep.py --workload CELL --seeds 1,2,... \
        --controls 1,2,3 [--seconds S] [--out FILE]

runs, on the card, at the cell's own sizes and through the cell's own
set-up, loop and comparison (``harness/serve_cell.py``,
``harness/train_cell.py``):

- for every seed of ``--seeds``, a sound run of the program (a serving
  run's window ``--seconds`` long, at the cell's load, after the mix's
  ramp) and the numbers its comparison reads;
- for every seed of ``--controls``, the control on the same inputs:
  the reference computed one precision below the configuration's
  (``reference/opt.py`` ``fp8_matmul``); for a training cell also two
  planted faults with the reference in the program's place: half of
  each batch left out, and steps that leave their state unchanged
  (their losses are the losses at the first weights).

A serving cell's model is built once and serves every seed through a
fresh engine. A training cell runs each seed in a process of its own
(this one, started again for it): five seeds in one process left too
little of the card for the sixth's captured step. One JSON line a
reading; the benchmark's own runs never run this.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

BASE = Path(__file__).resolve().parent
ROOT = BASE.parent


def _emit(out, row):
    line = json.dumps(row)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def serve_sweep(reg, cell, seeds, controls, seconds, out, cache,
                device="cuda"):
    from portbench.harness import serve_cell as sc, weights
    from portbench.harness.record import Run
    from portbench.reference import opt as ref

    wl, mc, mix = reg.cell(cell)
    model, cfg = sc.build(Run(cell, wl, mc, mix), device, str(cache))
    for seed in seeds:
        run = Run(cell, wl, mc, mix)
        sc.serve(run, model, cfg, device, seed, seconds, False,
                 time.perf_counter())
        sc.free(device)
        sc.judge(run, device, seed)
        row = {"cell": cell, "seed": seed, "kind": "program",
               "attempted": run.attempted, "failed": run.failed,
               "served_logit_gap": run.checks["served_logit_gap"]["value"],
               **run.info}
        if seed in controls:
            w = weights.make_tree(mc, seed, device,
                                  stored_dtype=sc.stored_dtype(mc))
            row["control_fp8_reference"] = sc.served_gap(
                w, mc, sc.sample(run, seed, int(mix["check_tokens"])),
                mm=ref.fp8_matmul)
            del w
            sc.free(device)
        _emit(out, row)


def train_sweep(reg, cell, seeds, controls, out, cache, device="cuda"):
    import torch
    from portbench.harness import serve_cell as sc, train_cell as tc, \
        weights
    from portbench.harness.record import Run
    from portbench.reference import opt as ref

    wl, mc, mix = reg.cell(cell)
    b, s = int(mix["batch"]), int(mix["seq"])
    n = 1 + int(mix["steps_per_call"])
    for seed in seeds:
        run = Run(cell, wl, mc, mix)
        model, losses, grad, change = tc.checked_steps(run, device, seed,
                                                       str(cache))
        del model
        sc.free(device)
        lr, gr, cr = tc.reference_steps(mc, seed, device, n, b, s)
        _emit(out, {"cell": cell, "seed": seed, "kind": "program",
                    **tc.gaps(losses, lr, grad, gr, change, cr),
                    "losses": losses, "reference": lr})
        if seed in controls:
            for kind, kw in (("control_fp8_reference",
                              {"mm": ref.fp8_matmul}),
                             ("fault_half_batch", {"half_batch": True})):
                lc, gc, cc = tc.reference_steps(mc, seed, device, n, b, s,
                                                **kw)
                _emit(out, {"cell": cell, "seed": seed, "kind": kind,
                            **tc.gaps(lc, lr, gc, gr, cc, cr)})
                sc.free(device)
            ref.exact()
            lu = tc.call_losses(ref.losses_at(
                weights.make_tree(mc, seed, device), mc,
                tc.reference_batches(mc, seed, device, n, b, s)))
            _emit(out, {"cell": cell, "seed": seed,
                        "kind": "fault_state_unchanged",
                        "loss_gap": max(abs(u - r) / abs(r)
                                        for u, r in zip(lu, lr))})
        del gr, cr
        sc.free(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from run import set_caches
    cache = set_caches(BASE)
    import torch
    from portbench.harness.registry import Registry
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    reg = Registry(BASE)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    controls = {int(x) for x in args.controls.split(",") if x}
    kind = reg.cell(args.workload)[1]["kind"]
    if kind == "train" and len(seeds) > 1:
        for seed in seeds:
            argv1 = ["--workload", args.workload, "--seeds", str(seed),
                     "--controls", str(seed) if seed in controls else ""]
            if args.out:
                argv1 += ["--out", args.out]
            rc = subprocess.run([sys.executable, __file__, *argv1]).returncode
            if rc:
                return rc
        return 0
    if kind == "serve":
        serve_sweep(reg, args.workload, seeds, controls, args.seconds,
                    args.out, cache)
    else:
        train_sweep(reg, args.workload, seeds, controls, args.out, cache)
    return 0


if __name__ == "__main__":
    sys.exit(main())
