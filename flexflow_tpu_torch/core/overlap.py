"""The train loop's dispatch window.

Counterpart of ``DispatchWindow`` in ``flexflow_tpu/core/overlap.py``.
The JAX module's bucketed gradient sync (``grad_bucket_mb``) needs a
data-parallel mesh and is not ported yet.
"""

from __future__ import annotations

import collections
import time
from typing import List

import torch


def _tree_map(fn, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(fn, v) for v in obj)
    return obj


class DispatchWindow:
    """Depth-N in-flight window over dispatched train-step results.

    ``push(entry)`` records one dispatch's result (metric tensors, each
    the dispatch's own copy: the executor clones a graph's static
    outputs, which the next replay overwrites). On the card it queues
    the copy of those tensors into pinned host memory right behind the
    dispatch, on the same stream, and records an event. Once more than
    ``depth - 1`` results are unfetched, the OLDEST is fetched: the host
    waits for its event, so it blocks at most on a step ``depth - 1``
    dispatches behind the newest. So:

      depth 1  -> synchronous (fetch right after each dispatch)
      depth 2  -> fetch step N while step N+1 runs (the default)
      depth 0  -> unbounded (fetch everything at drain())

    ``drain()`` fetches everything left (epoch ends, and fit's finally
    on a fault) and returns the fetched entries, host tensors in place
    of the device ones, in push order. ``fetch_waits_s`` records the
    host time blocked in each fetch, and with a telemetry bus each
    fetch is a ``fetch_wait`` span on the ``("train", "fetch")`` track.
    On the CPU an entry's tensors are already on the host."""

    def __init__(self, depth: int, telemetry=None):
        self.depth = max(0, int(depth))
        self._pending: collections.deque = collections.deque()
        self._done: List = []
        self.fetch_waits_s: List[float] = []
        self.max_in_flight = 0
        self._telemetry = telemetry

    @staticmethod
    def _start_copy(entry):
        """(entry with pinned host copies of its CUDA tensors, the event
        after those copies); (entry, None) when nothing is on a card."""
        dev = []

        def host(t):
            if t.device.type != "cuda":
                return t
            dev.append(t.device)
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            return h

        out = _tree_map(host, entry)
        if not dev:
            return out, None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev[0]))
        return out, ev

    def _fetch_oldest(self) -> None:
        entry, ev = self._pending.popleft()
        t0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        t1 = time.perf_counter()
        self._done.append(entry)
        self.fetch_waits_s.append(t1 - t0)
        if self._telemetry is not None and self._telemetry.enabled:
            self._telemetry.span(("train", "fetch"), "fetch_wait", t0, t1)

    def push(self, entry) -> None:
        self._pending.append(self._start_copy(entry))
        if len(self._pending) > self.max_in_flight:
            self.max_in_flight = len(self._pending)
        if self.depth > 0:
            while len(self._pending) > self.depth - 1:
                self._fetch_oldest()

    def pending(self) -> int:
        return len(self._pending)

    def drain(self) -> List:
        while self._pending:
            self._fetch_oldest()
        out = self._done
        self._done = []
        return out
