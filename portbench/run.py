"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``flexflow_tpu_torch``. The
cell's files (``workloads/CELL.json`` and the configuration and mix it
names) are read from this directory and its metrics from
``BENCHMARK.json`` beside it. The run sets up (weights and inputs from
``--seed``), measures for ``--seconds``, judges what the measured
window produced against the plain reference, and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, which also end standard error.

It exits non-zero and prints no result when the machine holds fewer
CUDA devices than the cell asks for, and when a module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``flexflow_tpu`` is loaded once
the window has closed. Build and kernel caches live in fixed
directories under ``portbench/.cache``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BASE = Path(__file__).resolve().parent
ROOT = BASE.parent


def set_caches(base: Path) -> Path:
    """Fixed cache directories inside the checkout; returns the
    program cache directory (the port's kernel libraries land in its
    ``kernels/``)."""
    cache = base / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("FLEXFLOW_TORCH_CACHE", "flexflow_torch")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    (cache / "programs").mkdir(parents=True, exist_ok=True)
    return cache / "programs"


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = set_caches(BASE)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench.harness.cells import forbidden_modules, run_cell
    from portbench.harness.registry import Registry

    reg = Registry(BASE)
    wl = reg.cell(args.workload)[0]
    chips = int(wl["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"portbench: the cell {args.workload} needs {chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr)
    out = run_cell(reg, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START, cache, chips)
    run = out.pop("_run")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"portbench: setup_s {run.setup_s:.3f}, window {run.window_s:.3f}"
          f" s, {len(run.window_steps()) or len(run.fit_calls)} steps or "
          f"calls, attempted {out['attempted']}, failed {out['failed']}",
          file=sys.stderr)
    print(f"portbench: {run.info}", file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
