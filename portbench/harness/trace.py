"""The device trace of a ``--trace 1`` run, reduced.

``torch.profiler`` (CPU and CUDA activities) records a sub-window of
the measured window, opened and closed at step boundaries, where the
device has drained. The benchmark marks its own host spans with
``record_function`` (names starting ``portbench.``), around each call
into the program. The reduction takes from the trace:

- every device event (kernels, copies, sets) as an interval; the span
  annotations the profiler mirrors onto the device are left out;
- the traced window: from the start of the first benchmark span to the
  end of the last, in the trace's clock;
- ``busy_s``: the union of the device intervals inside the window;
- the device time of each kernel name and each class
  (``kernel_classes.py``), summed;
- the idle gaps: stretches of the window where nothing ran on the
  device, each labelled with the benchmark span open over it and the
  innermost operation the host thread was inside (``python`` when
  none), summed by label.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from .kernel_classes import classify

SPAN_PREFIX = "portbench."


def span(name: str, on: bool):
    """A benchmark span around a call into the program, recorded only in
    a traced run."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Profiler:
    """Start and stop the profiler at step boundaries. ``warm()`` runs
    one short profile in set-up so that the tracer's first start is not
    paid inside the window."""

    def __init__(self):
        self._prof = None

    @staticmethod
    def _new():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self, device) -> None:
        p = self._new()
        p.start()
        x = torch.ones(1024, device=device)
        (x * 2).sum().item()
        p.stop()

    def start(self) -> None:
        self._prof = self._new()
        self._prof.start()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        prof, self._prof = self._prof, None
        return prof


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Reduced:
    """What the readers use of a trace (all times in seconds)."""

    def __init__(self, window_s: float, busy_s: float,
                 by_kernel: Dict[str, Tuple[float, int]],
                 by_class: Dict[str, float],
                 idle_by_label: Dict[str, float]):
        self.window_s = window_s
        self.busy_s = busy_s
        self.by_kernel = by_kernel
        self.by_class = by_class
        self.idle_by_label = idle_by_label

    def kernel_seconds(self, pattern) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels ``pattern``
        matches."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.by_kernel.items():
            if pattern.search(name):
                s += sec
                n += cnt
        return s, n

    def breakdown(self) -> dict:
        ops = sorted(self.by_kernel.items(), key=lambda kv: -kv[1][0])
        gaps = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k[:160], v[0]] for k, v in ops[:10]],
                "idle_gaps": [[k[:160], v] for k, v in gaps[:10]]}


def reduce(prof) -> Optional[Reduced]:
    """The trace reduced, or None when it holds no benchmark span or no
    device event."""
    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[float, float, str]] = []
    cpu = []
    spans = []
    for e in prof.events():
        name = e.name
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == cuda:
            if not name.startswith(SPAN_PREFIX) and b > a:
                dev.append((a, b, name))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], a, b, e.thread))
        else:
            cpu.append((a, b, name, e.thread))
    if not spans or not dev:
        return None
    w0 = min(s[1] for s in spans)
    w1 = max(s[2] for s in spans)
    main = spans[0][3]
    busy = _merge([(max(a, w0), min(b, w1)) for a, b, _ in dev
                   if b > w0 and a < w1])
    by_kernel: Dict[str, Tuple[float, int]] = {}
    by_class: Dict[str, float] = {}
    for a, b, name in dev:
        if b <= w0 or a >= w1:
            continue
        sec, cnt = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (sec + (b - a) * 1e-6, cnt + 1)
        c = classify(name)
        by_class[c] = by_class.get(c, 0.0) + (b - a) * 1e-6
    # idle gaps, labelled by the span and the innermost host op over
    # their midpoint
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    host = sorted((a, b, n) for a, b, n, t in cpu if t == main)
    starts = [h[0] for h in host]
    sp = sorted((a, b, n) for n, a, b, _ in spans)
    sp_starts = [s[0] for s in sp]
    idle: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = "between spans"
        i = bisect.bisect_right(sp_starts, mid) - 1
        if i >= 0 and sp[i][1] >= mid:
            label = sp[i][2]
        inner, j = "python", bisect.bisect_right(starts, mid) - 1
        best = None
        # the innermost host op containing mid: the latest-starting one
        # among those still open at mid (ops nest on one thread); looked
        # for among the 256 ops that started last before it
        for j in range(j, max(-1, j - 256), -1):
            if host[j][1] >= mid:
                best = host[j]
                break
        if best is not None:
            inner = best[2]
        key = f"{label}/{inner}"
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return Reduced((w1 - w0) * 1e-6, busy_s, by_kernel, by_class, idle)
