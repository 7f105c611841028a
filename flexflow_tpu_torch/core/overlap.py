"""The train loop's dispatch window and the gradient-bucket planner.

Counterpart of ``flexflow_tpu/core/overlap.py``: ``DispatchWindow``,
and the pricing half of the bucketed gradient sync —
``eligible_sparse_ops``, ``auto_bucket_mb``, ``resolve_bucket_mb`` and
``grad_buckets`` — which the strategy simulator reads to price the
partition the data-parallel executor syncs in (``FFConfig.grad_bucket_mb``)
— and its executing half, :class:`GradSync`.

JAX anchors each bucket's all-reduce inside the backward with a
``custom_vjp`` tag (``make_bucket_tagger``) and XLA schedules it. Here a
gradient hook on each parameter copies its gradient into its bucket's
flat buffer as autograd produces it; the hook that completes a bucket
launches the bucket's all-reduce at once (on a communication stream of
its own on the card, so the rest of the backward runs beside it; gloo
runs it on its own thread on the CPU), and the update waits for every
bucket after the backward. ``grad_bucket_mb=0`` is one flat all-reduce
after the backward. At two ranks a sum is ``a + b`` in any order, so
the bucketed and the monolithic sync are bit-identical; above two a
ring's summation order depends on where an element falls in its buffer,
so they agree to f32 rounding.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

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


def eligible_sparse_ops(model) -> set:
    """Names of embedding-family ops the executor routes through the
    sparse row-update path (mirror of ``Executor._sparse_table_ops``,
    shared so the simulator's bucket partition matches the executor's
    without holding an executor). Before compile() assigns an optimizer
    the set is empty — the conservative (dense) reading the cost model
    already uses."""
    from ..ops.embedding import DistributedEmbedding, Embedding
    cfg = model.config
    opt = getattr(model, "optimizer", None)
    mode = None
    if opt is not None:
        try:
            mode = opt.sparse_mode()
        except Exception:
            mode = None
    allowed = mode == "exact" or (
        mode == "lazy" and getattr(cfg, "sparse_embedding_lazy", False))
    out = set()
    if getattr(cfg, "sparse_embedding_updates", True) and allowed:
        input_uids = {t.uid for t in model.input_tensors}
        for op in model.ops:
            if isinstance(op, (Embedding, DistributedEmbedding)) \
                    and all(t.uid in input_uids for t in op.inputs):
                out.add(op.name)
    return out


# auto_bucket_mb bounds: never fewer than one bucket or more than this
# many (beyond ~32 the per-bucket launch latency dominates any overlap
# win), and never a bucket outside [1, 64] MiB (below 1 MiB a v5-class
# all-reduce is pure latency; above 64 MiB the last bucket's sync can
# no longer hide behind any remaining backward).
AUTO_MAX_BUCKETS = 32
AUTO_MIN_MB = 1.0
AUTO_MAX_MB = 64.0
# fraction of the estimated backward time the per-bucket launch
# latencies may consume before we stop splitting finer
AUTO_LATENCY_FRACTION = 0.1


def auto_bucket_mb(model, mesh=None, machine=None) -> float:
    """Machine-model-derived gradient-sync bucket size, used when
    FFConfig.grad_bucket_mb is unset (None = auto).

    The granularity trade is bandwidth-vs-latency: the TOTAL sync bytes
    and the total backward compute are fixed, so splitting finer only
    adds per-bucket all-reduce launch latency while anchoring syncs
    earlier in the backward. We size buckets from the machine model —
    effectively interconnect bandwidth x the expected backward slice a
    bucket must hide under: estimate the backward time (2x forward
    FLOPs at the calibrated MXU rate), allow AUTO_LATENCY_FRACTION of
    it for per-bucket launch latency (2(a-1) ICI hops per ring
    all-reduce), split the dense master bytes into that many buckets,
    and floor each bucket at the interconnect's bandwidth-latency
    product (a smaller bucket's all-reduce is pure latency — nothing
    for the backward to overlap). No data axis (or no dense weights)
    resolves to 0 = monolithic: there is no sync to overlap.

    Deterministic for a given (model, mesh): the executor (real step)
    and the simulator (search pricing) both resolve through
    resolve_bucket_mb, so they partition identically and the resolved
    value — not the None sentinel — folds into the cost-cache machine
    fingerprint."""
    data = int(mesh.shape.get("data", 1)) if mesh is not None else 1
    if data <= 1:
        return 0.0
    sparse = eligible_sparse_ops(model)
    total_bytes = sum(
        float(op.weight_bytes()) for op in model.ops
        if op.name not in sparse and op.weight_specs()
        and op.weight_bytes() > 0)
    if total_bytes <= 0:
        return 0.0
    if machine is None:
        from ..search.machine_model import default_machine_model
        machine = default_machine_model(mesh)
    eff = machine.efficiency.get("matmul", 0.5)
    t_bwd = 2.0 * sum(float(op.flops()) for op in model.ops) \
        / max(machine.peak_flops_for(None) * eff, 1.0)
    per_bucket_lat = 2.0 * (data - 1) * machine.spec.ici_latency
    n = max(1, min(AUTO_MAX_BUCKETS,
                   int(AUTO_LATENCY_FRACTION * t_bwd
                       / max(per_bucket_lat, 1e-12))))
    bw = machine.spec.ici_bandwidth \
        * machine.efficiency.get("collective", 0.75)
    floor_bytes = bw * per_bucket_lat   # bandwidth-latency product
    bucket_bytes = max(total_bytes / n, floor_bytes)
    return float(min(max(bucket_bytes / (1 << 20), AUTO_MIN_MB),
                     AUTO_MAX_MB))


def resolve_bucket_mb(config, model, mesh=None, machine=None) -> float:
    """The ONE resolution point for FFConfig.grad_bucket_mb: explicit
    values (including 0 = monolithic) are authoritative; None
    auto-tunes from the machine model (auto_bucket_mb). Both the
    executor's sync-point partition and the simulator's bucket pricing
    — and the cost-cache fingerprint — use the value returned here."""
    raw = getattr(config, "grad_bucket_mb", None)
    if raw is not None:
        return float(raw)
    try:
        return auto_bucket_mb(model, mesh=mesh, machine=machine)
    except Exception:
        # a half-built model (no ops yet) or an exotic mesh must not
        # break compile — fall back to the legacy monolithic sync
        return 0.0


def grad_buckets(model, bucket_mb: float,
                 sparse_ops: Optional[set] = None
                 ) -> List[Tuple[List[str], float]]:
    """Walk-order contiguous gradient-sync buckets.

    Returns ``[(member op names, master-param bytes), ...]`` over the
    ops that contribute DENSE float gradients to the data-parallel sync
    (weighted ops minus the sparse-update tables, whose row gradients
    scatter outside the bucketed reduction). A bucket closes once its
    cumulative ``op.weight_bytes()`` (the f32-declared master basis —
    strategy-independent, so executor and simulator always agree)
    reaches ``bucket_mb`` MiB. ``bucket_mb <= 0`` returns [] (legacy
    monolithic sync)."""
    if bucket_mb is None or bucket_mb <= 0:
        return []
    if sparse_ops is None:
        sparse_ops = eligible_sparse_ops(model)
    limit = float(bucket_mb) * (1 << 20)
    buckets: List[Tuple[List[str], float]] = []
    cur: List[str] = []
    cur_bytes = 0.0
    for op in model.ops:
        if op.name in sparse_ops or not op.weight_specs():
            continue
        w = float(op.weight_bytes())
        if w <= 0:
            continue
        cur.append(op.name)
        cur_bytes += w
        if cur_bytes >= limit:
            buckets.append((cur, cur_bytes))
            cur, cur_bytes = [], 0.0
    if cur:
        buckets.append((cur, cur_bytes))
    return buckets


class GradSync:
    """The dense gradient sum over one mesh axis (or a tuple of axes,
    summed as one group), in buckets.

    ``buckets`` lists ``(op, weight)`` keys in walk order, a bucket a
    list; ``params`` gives each key's tensor (its shape and dtype; a
    bucket keeps one flat buffer a dtype). With ``hooked`` the buckets
    launch from gradient hooks during the backward (:meth:`arm`), else
    all at once in :meth:`finish`. A parameter whose gradient never
    arrives (unused in this step) contributes zeros."""

    def __init__(self, bm, axis: str, buckets: List[list], params,
                 hooked: bool = True):
        self.bm, self.axis, self.hooked = bm, axis, hooked
        self.buckets = [list(b) for b in buckets]
        self._where: Dict[tuple, tuple] = {}
        self._layout: List[Dict[torch.dtype, int]] = []
        for bi, b in enumerate(self.buckets):
            sizes: Dict[torch.dtype, int] = {}
            for key in b:
                t = params[key[0]][key[1]]
                off = sizes.get(t.dtype, 0)
                self._where[key] = (bi, t.dtype, off, t.numel(),
                                    tuple(t.shape))
                sizes[t.dtype] = off + t.numel()
            self._layout.append(sizes)
        self.launched = 0      # bucket all-reduces of the last step
        self._reset()

    def bucket_bytes(self) -> List[int]:
        return [sum(n * dt.itemsize for dt, n in sizes.items())
                for sizes in self._layout]

    def _reset(self) -> None:
        self._bufs: List[Optional[Dict]] = [None] * len(self.buckets)
        self._left = [len(b) for b in self.buckets]
        self._done = [False] * len(self.buckets)
        self._pending: List = []
        self._comm = None
        self._cur = None

    def _stream_ctx(self, dev):
        """The communication stream's context under NCCL on the card
        (forked from the stream the backward runs on), else nothing."""
        import contextlib
        if dev.type != "cuda" or self.bm.backend != "nccl":
            return contextlib.nullcontext()
        if self._comm is None:
            self._comm = _comm_stream(dev)
        cur = torch.cuda.current_stream(dev)
        if self._cur is None:
            self._cur = cur
        self._comm.wait_stream(cur)
        return torch.cuda.stream(self._comm)

    def _alloc(self, bi: int, dev) -> Dict:
        if self._bufs[bi] is None:
            self._bufs[bi] = {dt: torch.zeros(n, dtype=dt, device=dev)
                              for dt, n in self._layout[bi].items()}
        return self._bufs[bi]

    def _launch(self, bi: int) -> None:
        from ..parallel.collectives import all_reduce_
        self._done[bi] = True
        for buf in self._bufs[bi].values():
            self._pending.append(all_reduce_(buf, self.bm, self.axis,
                                             async_op=True))
        self.launched += 1

    def _put(self, key, g) -> None:
        bi, dt, off, n, _ = self._where[key]
        with self._stream_ctx(g.device):
            bufs = self._alloc(bi, g.device)
            bufs[dt][off:off + n].copy_(g.reshape(-1))
            if self._comm is not None:
                g.record_stream(self._comm)
            self._left[bi] -= 1
            if self._left[bi] == 0 and self.hooked:
                self._launch(bi)

    def arm(self, params) -> list:
        """Register this step's hooks on the bucketed parameters (the
        caller removes the returned handles after the backward)."""
        self._reset()
        self.launched = 0
        if not self.hooked:
            return []
        handles = []
        for key in self._where:
            t = params[key[0]][key[1]]
            if t.requires_grad:
                handles.append(t.register_hook(
                    lambda g, _k=key: self._put(_k, g)))
        return handles

    def finish(self, grads) -> Dict[tuple, torch.Tensor]:
        """Launch what is left (every bucket when not hooked), wait for
        all of them, and return the summed gradients as views of the
        buffers, by key."""
        if not self.hooked:
            self._reset()
            self.launched = 0
            for key in self._where:
                self._put(key, grads[key[0]][key[1]])
        for bi, b in enumerate(self.buckets):
            if not self._done[bi]:
                # the monolithic launch, or a bucket some of whose
                # parameters got no gradient this step (their zeros)
                dev = grads[b[0][0]][b[0][1]].device
                with self._stream_ctx(dev):
                    self._alloc(bi, dev)
                    self._launch(bi)
        for p in self._pending:
            p.wait()
        if self._comm is not None:
            cur = self._cur or torch.cuda.current_stream()
            cur.wait_stream(self._comm)
            for bufs in self._bufs:
                for buf in (bufs or {}).values():
                    buf.record_stream(cur)
        out = {}
        for key, (bi, dt, off, n, shape) in self._where.items():
            out[key] = self._bufs[bi][dt][off:off + n].view(shape)
        self._reset()
        return out


_COMM: Dict = {}


def _comm_stream(dev):
    """One communication stream a card."""
    s = _COMM.get(dev)
    if s is None:
        s = _COMM[dev] = torch.cuda.Stream(dev)
    return s
