"""Split a serving trace's device-idle time by the step's host ranges.

    python3 tools/torch_serve_ranges.py TRACE.json

TRACE.json is a Chrome trace that ``torch.profiler`` exported while the
PyTorch/CUDA port's ``ServeSession`` stepped: the ``trace.json`` that
``utils/profiling.trace`` writes (``--trace-dir``), or any
``export_chrome_trace`` of a profiler with CUDA activity. The step
names its host phases there with the ranges of
``profiling.SERVE_RANGES`` (plan, pack, stage, commit, emit).

The device is busy over the union of its kernels, copies and sets (the
user annotations a profiler mirrors onto the device are left out). A
step runs from its first plan range to the end of its emit range. Each
stretch of idle device time inside a step is cut at the edges of the
ranges and of the CUDA runtime calls on the step's thread, and each
piece is counted where it lies: in a range, in a runtime call, or in
neither (the step's host Python outside the ranges: the program's call
before its input copy, the readback, the drains). The ranges' share is
their idle time over theirs plus that of the host Python outside them.

Prints one JSON object, every time in ms a step (a step: one pack
range): ``steps``, ``busy_ms``, ``step_idle_ms``, ``ranges`` (each
range's ``host_ms`` and ``idle_ms``), ``in_runtime_calls_ms``,
``outside_ranges_ms``, ``range_share`` and
``device_events_named_ff`` (which should be 0: a range holds host work
only, and the profiler does not mirror it onto the device).
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from flexflow_tpu_torch.utils.profiling import (SERVE_EMIT,  # noqa: E402
                                                SERVE_PACK, SERVE_PLAN,
                                                SERVE_RANGES)

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver"}

Span = Tuple[float, float]


def _merge(spans: Sequence[Span]) -> List[Span]:
    out: List[Span] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        elif b > a:
            out.append((a, b))
    return out


def _subtract(spans: Sequence[Span], holes: Sequence[Span]) -> List[Span]:
    """The parts of ``spans`` outside ``holes`` (both merged)."""
    out: List[Span] = []
    j = 0
    for a, b in spans:
        while j < len(holes) and holes[j][1] <= a:
            j += 1
        k = j
        while k < len(holes) and holes[k][0] < b:
            if holes[k][0] > a:
                out.append((a, holes[k][0]))
            a = max(a, holes[k][1])
            k += 1
        if b > a:
            out.append((a, b))
    return out


class _Busy:
    """The device's busy union, for the idle time inside a span."""

    def __init__(self, spans: Sequence[Span]):
        self.spans = _merge(spans)
        self.starts = [a for a, _ in self.spans]

    def idle(self, a: float, b: float) -> float:
        busy = 0.0
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        while i < len(self.spans) and self.spans[i][0] < b:
            lo, hi = max(a, self.spans[i][0]), min(b, self.spans[i][1])
            if hi > lo:
                busy += hi - lo
            i += 1
        return (b - a) - busy


def split(events: Sequence[dict]) -> Dict:
    """The split of a Chrome trace's ``traceEvents`` (times in us)."""
    dev, named_ff, ranges = [], 0, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((a, b))
            named_ff += name.startswith("ff.")
        elif cat == "gpu_user_annotation":
            named_ff += name.startswith("ff.")
        elif name in SERVE_RANGES:
            ranges.append((a, b, name, e.get("tid")))
    ranges.sort()
    threads = {r[3] for r in ranges}
    runtime = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in events
                      if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS
                      and e.get("tid") in threads])
    busy = _Busy(dev)
    # a step: from the plan range after an emit range (or the first)
    # to the end of the next emit range
    steps: List[Span] = []
    start = None
    for a, b, name, _ in ranges:
        if name == SERVE_PLAN and start is None:
            start = a
        elif name == SERVE_EMIT and start is not None:
            steps.append((start, b))
            start = None
    n_steps = sum(name == SERVE_PACK for _, _, name, _ in ranges)
    n = max(1, n_steps)
    per = {name: {"host_ms": 0.0, "idle_ms": 0.0} for name in SERVE_RANGES}
    for a, b, name, _ in ranges:
        per[name]["host_ms"] += (b - a) * 1e-3 / n
        per[name]["idle_ms"] += busy.idle(a, b) * 1e-3 / n
    in_ranges = _merge([(a, b) for a, b, _, _ in ranges])
    calls = _subtract(runtime, in_ranges)
    rest = _subtract(_subtract(steps, in_ranges), _merge(calls))
    calls = [(max(a, s0), min(b, s1)) for a, b in calls
             for s0, s1 in steps if a < s1 and b > s0]

    def idle_ms(spans):
        return sum(busy.idle(a, b) for a, b in spans) * 1e-3 / n

    ranged = sum(v["idle_ms"] for v in per.values())
    outside = idle_ms(rest)
    return {
        "steps": n_steps,
        "busy_ms": sum((b - a) - busy.idle(a, b) for a, b in steps)
        * 1e-3 / n,
        "step_idle_ms": idle_ms(steps),
        "ranges": per,
        "in_runtime_calls_ms": idle_ms(calls),
        "outside_ranges_ms": outside,
        "range_share": ranged / (ranged + outside)
        if ranged + outside > 0 else None,
        "device_events_named_ff": named_ff,
    }


def load(path) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a torch.profiler Chrome trace (JSON)")
    args = ap.parse_args(argv)
    print(json.dumps(split(load(args.trace))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
