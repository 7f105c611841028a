"""Pipeline parallelism over arbitrary op graphs: the counterpart of
``flexflow_tpu/parallel/graph_pipeline.py``, planner and executing
halves.

The planner (what the strategy simulator reads as well):

  * ``StagePlan``, ``build_stage_plan`` — a partition of the op graph
    into S contiguous stages with the cut tensors each inter-stage hop
    carries; ``balanced_stages`` (flops-balanced auto-cut),
    ``assignment_from_pins`` (stages from a strategy's whole-op device
    pins) and ``pick_pipe_axis``;
  * the schedule tables ``one_f_one_b_schedule``,
    ``interleaved_schedule``, ``interleaved_forward_schedule`` and the
    port's ``gpipe_schedule`` (``FWD``/``BWD``/``IDLE`` per tick and
    device), ``schedule_bubble`` and ``bubble_fraction``;
  * ``PackSpec`` / ``make_pack_spec`` — JAX's per-stage flat packing,
    kept here as the DESCRIPTION of what each pipe rank holds: stage s
    lives on pipe coordinate s mod D, its rows in device-major order at
    v = S / D > 1, each dtype's row padded to the ``data`` size under
    ZeRO-1. The port does not pack: a rank's parameters are its own
    tensors, ``{op: {name: tensor}}`` for the ops of its stages, and
    their bytes are its rows' (``PackSpec.rank_bytes``).

The executing half, one process a pipe rank on a ``torch.distributed``
group (parallel/mesh.py). JAX runs every stage body on every device at
every tick (``shard_map`` + ``lax.switch`` on the stage index); here
each rank runs only its own list of actions — the rows of a schedule
table for its pipe coordinate — and the activations and cotangents
travel point to point (parallel/collectives.py ``send_next`` /
``recv_prev`` and ``send_prev`` / ``recv_next``), all of a rank's
transfers of one tick posted together:

  * ``pipeline_logits`` — the forward ticks of GPipe (tick t, stage s
    runs microbatch t - s), forward only: the evaluation and
    ``forward`` path at v = 1. The last stage's outputs reach every pipe
    rank (JAX's psum over ``pipe``).
  * ``pipeline_grads`` — a training step: under ``"gpipe"`` all the
    forward ticks, then the reverse ticks, each microbatch's backward by
    autograd from the graph its forward kept; under ``"1f1b"`` the
    action order of ``interleaved_schedule`` (v = 1: plain 1F1B), each
    in-flight microbatch keeping its graph until its backward — at most
    ``peak_microbatches`` a stage, JAX's bound, where JAX recomputes
    the forward in the backward instead (JAX's
    ``pipeline_1f1b_grads``).
  * ``pipeline_logits_interleaved`` — the forward-only interleaved
    schedule (evaluation at v > 1).

Each microbatch of the step's key ``rng`` draws from ``fold_in(rng, m)``
and the i-th op of a stage from ``fold_in(fold_in(rng, m), i)`` (i the
op's index within its stage; core/prng.py), so a pipelined run's
dropout masks are JAX's pipelined masks, not the one-device run's.
Microbatches split over ``data`` inside each stage when they divide
(``_data_split``): each data rank holds rows ``[c mb/n, (c+1) mb/n)`` of
every microbatch, computes local BatchNorm statistics, and the weight
gradients are summed (the state rows averaged) over ``data`` after the
schedule. Every microbatch's loss counts 1/(M n) of the objective and
its aux losses 1/(M n), JAX's scaling (the global batch's mean).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..op import Op, OpContext

# --------------------------------------------------------------------------

@dataclasses.dataclass
class StagePlan:
    """Partition of a model's op graph into pipeline stages.

    stages[s]    ops of stage s, in topological order
    stage_of     op name -> stage index
    cuts[i]      tensors crossing the boundary between stages <= i and
                 stages > i (each must ride hop i of the wire)
    """

    stages: List[List[Op]]
    stage_of: Dict[str, int]
    cuts: List[List]  # List[List[Tensor]]

    @property
    def num_stages(self) -> int:
        return len(self.stages)


def _check_supported(model, stage_of: Dict[str, int]) -> None:
    # stateful ops (BatchNorm) are legal under BOTH schedules: packed
    # state rows advance per microbatch in order at fwd ticks
    # (grad-accumulation semantics); 1F1B's backward recompute reads
    # state as a constant, guarded by Op.training_output_reads_state
    # (StagedExecutor rejects ops that set it)
    for op in model.ops:
        if op.op_type == "pipeline_blocks":
            raise NotImplementedError(
                f"graph pipeline: {op.name!r} is itself a pipeline "
                f"meta-op; nesting pipelines is not supported")
        if op.name not in stage_of:
            raise ValueError(f"op {op.name!r} has no stage assignment")


def build_stage_plan(model, stage_of: Dict[str, int]) -> StagePlan:
    """Materialize a StagePlan from an op->stage map. Validates that
    data flows forward (producer stage <= consumer stage) and computes
    the cut tensors every hop must carry."""
    _check_supported(model, stage_of)
    S = max(stage_of.values()) + 1
    producer = {}
    for op in model.ops:
        for t in op.outputs:
            producer[t.uid] = op.name
    input_uids = {t.uid for t in model.input_tensors}
    for op in model.ops:
        for t in op.inputs:
            if t.uid in input_uids:
                continue  # graph inputs are microbatch-fed to every stage
            ps = stage_of[producer[t.uid]]
            if ps > stage_of[op.name]:
                raise ValueError(
                    f"stage assignment sends tensor {t.uid} backward: "
                    f"producer {producer[t.uid]!r} is stage {ps}, "
                    f"consumer {op.name!r} is stage "
                    f"{stage_of[op.name]} — pipeline hops only go "
                    f"forward")
    stages: List[List[Op]] = [[] for _ in range(S)]
    for op in model.ops:  # model.ops is topological order
        stages[stage_of[op.name]].append(op)

    # last consumer stage per tensor; the model output is virtually
    # consumed at the last stage (it must arrive there to be emitted)
    last_use: Dict[int, int] = {}
    for op in model.ops:
        for t in op.inputs:
            if t.uid in input_uids:
                continue
            last_use[t.uid] = max(last_use.get(t.uid, 0),
                                  stage_of[op.name])
    final_uid = model.final_tensor.uid
    last_use[final_uid] = S - 1

    cuts: List[List] = []
    by_uid = {}
    for op in model.ops:
        for t in op.outputs:
            by_uid[t.uid] = t
    batch = model.input_tensors[0].shape[0] if model.input_tensors \
        else None
    for i in range(S - 1):
        cut = [by_uid[uid] for uid, last in sorted(last_use.items())
               if stage_of[producer[uid]] <= i < last]
        for t in cut:
            # the wire microbatches dim 0: a tensor whose dim 0 is NOT
            # the batch (e.g. GroupBy's (capacity, D) expert buffers)
            # would be silently reinterpreted sample-wise
            if batch is not None and (not t.shape
                                      or t.shape[0] != batch):
                raise NotImplementedError(
                    f"graph pipeline: tensor {t.uid} "
                    f"(shape {t.shape}, producer "
                    f"{producer[t.uid]!r}) crosses the stage-"
                    f"{i}/{i + 1} boundary but its dim 0 is not the "
                    f"batch dim ({batch}); cut elsewhere")
        cuts.append(cut)
    return StagePlan(stages=stages, stage_of=dict(stage_of), cuts=cuts)


def balanced_stages(model, num_stages: int) -> Dict[str, int]:
    """Flops-balanced contiguous auto-cut: partition the topological op
    order into `num_stages` segments minimizing the max per-stage flops
    (linear-partition DP). The searchable analog of the reference's
    hand-chosen per-layer placements."""
    ops = model.ops
    n = len(ops)
    S = min(num_stages, n)
    costs = [max(float(op.flops()), 1.0) for op in ops]
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    def seg(i, j):  # cost of ops[i:j]
        return prefix[j] - prefix[i]

    INF = float("inf")
    # dp[k][j] = best max-stage-cost splitting ops[:j] into k stages
    dp = [[INF] * (n + 1) for _ in range(S + 1)]
    cut = [[0] * (n + 1) for _ in range(S + 1)]
    dp[0][0] = 0.0
    for k in range(1, S + 1):
        for j in range(k, n + 1):
            for i in range(k - 1, j):
                c = max(dp[k - 1][i], seg(i, j))
                if c < dp[k][j]:
                    dp[k][j] = c
                    cut[k][j] = i
    bounds = [n]
    j = n
    for k in range(S, 0, -1):
        j = cut[k][j]
        bounds.append(j)
    bounds.reverse()  # [0, c1, ..., n]
    stage_of = {}
    for s in range(S):
        for op in ops[bounds[s]:bounds[s + 1]]:
            stage_of[op.name] = s
    return stage_of


def assignment_from_pins(model, strategy) -> Optional[Dict[str, int]]:
    """Derive a stage assignment from a strategy's whole-op device pins
    (length-1 `__devices__` tuples on non-embedding ops) — the
    executable lowering of reference propagate-placed strategies
    (model.cc:1807-1903). Stage order = device-id order. Unpinned ops
    inherit the latest stage among their producers. Returns None when no
    such pins exist; raises if the pins cannot form a forward pipeline
    (caller falls back to replication with the compile warning)."""
    pins = {}
    for op in model.ops:
        s = strategy.for_op(op.name)
        ids = s.device_ids
        if ids is None or op.op_type == "distributed_embedding":
            continue
        if len(set(ids)) != 1:
            raise ValueError(
                f"op {op.name!r}: multi-device pin {ids} has no "
                f"executable lowering (whole-op pins = one device id; "
                f"use axis_map sharding for intra-op splits)")
        pins[op.name] = int(ids[0])
    if not pins:
        return None
    order = sorted(set(pins.values()))
    rank = {d: i for i, d in enumerate(order)}
    producer = {}
    for op in model.ops:
        for t in op.outputs:
            producer[t.uid] = op.name
    input_uids = {t.uid for t in model.input_tensors}
    stage_of: Dict[str, int] = {}
    for op in model.ops:
        inherited = 0
        for t in op.inputs:
            if t.uid not in input_uids:
                inherited = max(inherited, stage_of[producer[t.uid]])
        stage_of[op.name] = (rank[pins[op.name]] if op.name in pins
                             else inherited)
    # pipelining is only meaningful for SEQUENTIAL placements: each
    # consecutive stage pair must be bridged by a real data edge
    # (producer in stage i feeding a consumer in stage i+1). Pins on
    # parallel SIBLING branches (e.g. DLRM's independent per-table
    # embeddings round-robined over devices) express concurrency, not
    # a pipeline — serializing them into stages would slow them down;
    # they fall back to the simulator's per-device concurrency pricing
    # (and, for embeddings, the distributed_embedding slot layout is
    # the executable form).
    S = max(stage_of.values()) + 1
    if S > 1:
        bridged = [False] * (S - 1)
        for op in model.ops:
            dst = stage_of[op.name]
            for t in op.inputs:
                if t.uid in input_uids:
                    continue
                src = stage_of[producer[t.uid]]
                if src == dst - 1:
                    bridged[src] = True
        if not all(bridged):
            gap = bridged.index(False)
            raise ValueError(
                f"pins do not form a sequential pipeline: no tensor "
                f"flows from stage {gap} to stage {gap + 1} (the "
                f"pinned ops are parallel siblings — placement there "
                f"means concurrency, not pipelining)")
    return stage_of


def pick_pipe_axis(mesh, num_stages: int) -> Optional[str]:
    """Mesh axis to pipeline over: prefer an axis literally named
    'pipe'/'layer' of the right size, else any non-'data' axis whose
    size equals the stage count."""
    if mesh is None:
        return None
    for name in ("pipe", "layer"):
        if mesh.shape.get(name) == num_stages:
            return name
    for name, size in mesh.shape.items():
        if name != "data" and size == num_stages:
            return name
    return None


# --------------------------------------------------------------------------
# residency: what each pipe rank holds (JAX's packing, as a description)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Segment:
    stage: int
    dtype: str
    offset: int
    size: int
    shape: Tuple[int, ...]
    row: int = -1  # physical row (= stage unless an interleaved layout
    #                permutes ownership)

    def __post_init__(self):
        if self.row < 0:
            self.row = self.stage


@dataclasses.dataclass
class PackSpec:
    """JAX's layout of per-stage flat-packed tensors: each stage's
    weights (or op state) flattened into one row per dtype, zero-padded
    to the longest stage, the rows sharded over the pipe axis. At
    v = S / D > 1 stage s lives on device s % D and rows go in
    device-major order, row(s) = (s % D) v + s // D, so device d owns
    rows [d v, (d + 1) v).

    The port stores no packed rows: a rank keeps its stages' tensors as
    they are. This spec is what their bytes are held against: a rank's
    parameters take :meth:`rank_bytes` (its rows' segments), and under
    ZeRO-1 each f32 optimizer slot takes its rows' lengths (padded to
    the ``data`` size) divided over ``data``."""

    segments: Dict[Tuple[str, str], _Segment]  # (op, weight) -> segment
    lengths: Dict[str, int]                    # dtype -> L
    num_stages: int
    virtual_stages: int = 1

    def row_layout(self, stage: int) -> List[Tuple[str, str, _Segment]]:
        return [(op, w, seg) for (op, w), seg in self.segments.items()
                if seg.stage == stage]

    def rank_rows(self, coord: int) -> List[int]:
        """The rows pipe coordinate ``coord`` owns."""
        v = self.virtual_stages
        return list(range(coord * v, (coord + 1) * v))

    def rank_bytes(self, coord: int) -> int:
        """Bytes of the segments in ``coord``'s rows (their padding
        left out): what the rank holds as its tensors."""
        rows = set(self.rank_rows(coord))
        return sum(seg.size * _itemsize(seg.dtype)
                   for seg in self.segments.values() if seg.row in rows)


def _itemsize(dt: str) -> int:
    return torch.empty((), dtype=getattr(torch, dt)).element_size()


def make_pack_spec(plan: StagePlan, n_dev: Optional[int] = None,
                   specs_of=None, pad_to: int = 1) -> PackSpec:
    """The per-stage layout (JAX's ``make_pack_spec``): ``specs_of``
    selects what packs (default: weight_specs; ``lambda op:
    op.state_specs()`` for op state). ``pad_to`` rounds each dtype's
    row length up to a multiple: the data axis size under ZeRO-1."""
    from ..core.precision import dtype_name
    if specs_of is None:
        specs_of = lambda op: op.weight_specs()  # noqa: E731
    S = plan.num_stages
    v = 1
    if n_dev is not None and n_dev > 0 and S != n_dev:
        if S % n_dev != 0:
            raise ValueError(
                f"{S} stages do not divide over {n_dev} devices")
        v = S // n_dev

    def row_of(s: int) -> int:
        return (s % n_dev) * v + s // n_dev if v > 1 else s

    segments: Dict[Tuple[str, str], _Segment] = {}
    lengths: Dict[str, int] = {}
    for s, ops in enumerate(plan.stages):
        offsets: Dict[str, int] = {}
        for op in ops:
            for wname, spec in specs_of(op).items():
                dt = dtype_name(spec.dtype)
                size = int(np.prod(spec.shape)) if spec.shape else 1
                off = offsets.get(dt, 0)
                segments[(op.name, wname)] = _Segment(
                    stage=s, dtype=dt, offset=off, size=size,
                    shape=tuple(spec.shape), row=row_of(s))
                offsets[dt] = off + size
        for dt, end in offsets.items():
            lengths[dt] = max(lengths.get(dt, 0), end)
    if not lengths:  # weightless graph: one dummy lane, as in JAX
        lengths["float32"] = 1
    if pad_to > 1:
        lengths = {dt: -(-L // pad_to) * pad_to
                   for dt, L in lengths.items()}
    return PackSpec(segments=segments, lengths=lengths,
                    num_stages=S, virtual_stages=v)


# --------------------------------------------------------------------------
# schedule tables
# --------------------------------------------------------------------------

IDLE, FWD, BWD = 0, 1, 2


def _ring_depth(fwd_done, consume_done, S: int, M: int, start: int,
                what: str) -> int:
    """Smallest safe activation ring-buffer depth for a generated
    schedule. The hazard is the ARRIVAL tick: act(m2) lands in stage
    s's buffer one tick after fwd(s-1, m2) runs (not when fwd(s, m2)
    runs), so slot m2 % depth must not be overwritten before the
    consumer has used act(m) — consumption is bwd(s, m) for training
    schedules, fwd(s, m) for forward-only ones."""
    def conflict_free(dep: int) -> bool:
        for s in range(1, S):  # stage 0 takes no wire arrivals
            for m in range(M):
                for m2 in range(m + 1, M):
                    if m2 % dep != m % dep:
                        continue
                    if fwd_done[s - 1][m2] + 1 <= consume_done[s][m]:
                        return False
        return True

    depth = max(1, start)
    while depth < M and not conflict_free(depth):
        depth += 1
    if not conflict_free(depth):
        raise AssertionError(
            f"{what} has no conflict-free ring depth <= {M}")
    return depth


def one_f_one_b_schedule(S: int, M: int):
    """Plain (non-interleaved) 1F1B: the v=1 case of
    `interleaved_schedule`, kept as the historical entry point —
    one stage per device, kind/mbi tables only."""
    kind, mbi, _sidx, _depth = interleaved_schedule(S, 1, M)
    return kind, mbi


def interleaved_schedule(n_dev: int, v: int, M: int):
    """Interleaved (virtual-stage) 1F1B: S = v * n_dev stages, stage s
    lives on device s % n_dev (round-robin, so every s -> s+1 hop is a
    +1 ring neighbor), each DEVICE runs one unit per tick. With v > 1 a
    device starts chunk c+1's forwards while chunk c waits on
    downstream, dividing the warmup/drain bubble by ~v (the Megatron
    interleaved schedule). v=1 reduces to plain 1F1B.

    Greedy event-driven generation with backward priority (memory
    bound); among ready forwards, the smallest (microbatch, stage)
    first — pushing each microbatch deep as early as possible.

    Returns (kind (T, D), mbi (T, D), sidx (T, D), depth) where sidx is
    the GLOBAL stage id worked each tick (-1 idle) and `depth` is the
    per-stage ring-buffer depth the executor must allocate (validated
    conflict-free against the schedule).
    """
    D, S = n_dev, v * n_dev
    fwd_done = [[-1] * M for _ in range(S)]
    bwd_done = [[-1] * M for _ in range(S)]
    next_f = [0] * S
    next_b = [0] * S
    kind_rows, mbi_rows, sidx_rows = [], [], []
    t = 0
    while any(nb < M for nb in next_b):
        krow = [IDLE] * D
        mrow = [-1] * D
        srow = [-1] * D
        for d in range(D):
            stages = [d + c * D for c in range(v)]
            # backward first: smallest microbatch, then DEEPEST stage
            # (its cotangent unblocks the longest chain)
            best = None
            for s in sorted(stages, reverse=True):
                m = next_b[s]
                if m >= M:
                    continue
                ready = (s == S - 1 and 0 <= fwd_done[s][m] < t) or \
                    (s < S - 1 and 0 <= bwd_done[s + 1][m] < t)
                if ready:
                    if best is None or m < best[1]:
                        best = (s, m, BWD)
            if best is None:
                # fwd in WAVES: microbatch groups of D run chunk-major
                # (chunk c's wave completes before chunk c+1's), the
                # Megatron interleaved pattern — measurably the best of
                # the policies tried (30-60% bubble reduction at v=4
                # across D/M sweeps; see test_interleaved_schedule)
                cand = []
                for s in stages:
                    m = next_f[s]
                    if m >= M or next_f[s] - next_b[s] >= max(1, S - s):
                        continue
                    if s == 0 or 0 <= fwd_done[s - 1][m] < t:
                        cand.append((m // D, s // D, m, s))
                if cand:
                    _, _, m, s = min(cand)
                    best = (s, m, FWD)
            if best is not None:
                s, m, k = best
                krow[d], mrow[d], srow[d] = k, m, s
                if k == FWD:
                    fwd_done[s][m] = t
                    next_f[s] += 1
                else:
                    bwd_done[s][m] = t
                    next_b[s] += 1
        kind_rows.append(krow)
        mbi_rows.append(mrow)
        sidx_rows.append(srow)
        t += 1
        if t > 4 * v * (M + S) + 8:
            raise AssertionError("interleaved schedule did not converge")
    # ring-buffer depth: start at the max in-flight forwards any stage
    # holds, then grow until slot-reuse is provably safe (_ring_depth;
    # consumption = the bwd tick)
    inflight = [0] * S
    peak = [0] * S
    for krow, srow in zip(kind_rows, sidx_rows):
        for k, s in zip(krow, srow):
            if k == FWD:
                inflight[s] += 1
                peak[s] = max(peak[s], inflight[s])
            elif k == BWD:
                inflight[s] -= 1
    depth = _ring_depth(
        fwd_done, bwd_done, S, M, start=max(peak),
        what=f"interleaved schedule (D={n_dev}, v={v}, M={M})")
    return (np.asarray(kind_rows, np.int32),
            np.asarray(mbi_rows, np.int32),
            np.asarray(sidx_rows, np.int32), depth)


def schedule_bubble(kind) -> float:
    """Idle fraction of the device timeline a generated schedule
    leaves (warmup + drain + dependency stalls)."""
    total = kind.size
    busy = int((kind != IDLE).sum())
    return 1.0 - busy / total


def interleaved_forward_schedule(n_dev: int, v: int, M: int):
    """Forward-only interleaved schedule (evaluation under virtual
    stages): the wave policy of :func:`interleaved_schedule` without
    the backward units and the in-flight cap. Returns (kind (T, D), mbi,
    sidx, depth) with the same conventions (kind is FWD or IDLE)."""
    D, S = n_dev, v * n_dev
    fwd_done = [[-1] * M for _ in range(S)]
    next_f = [0] * S
    kind_rows, mbi_rows, sidx_rows = [], [], []
    t = 0
    while any(nf < M for nf in next_f):
        krow = [IDLE] * D
        mrow = [-1] * D
        srow = [-1] * D
        for d in range(D):
            stages = [d + c * D for c in range(v)]
            cand = []
            for s in stages:
                m = next_f[s]
                if m >= M:
                    continue
                if s == 0 or 0 <= fwd_done[s - 1][m] < t:
                    cand.append((m // D, s // D, m, s))
            if cand:
                _, _, m, s = min(cand)
                krow[d], mrow[d], srow[d] = FWD, m, s
                fwd_done[s][m] = t
                next_f[s] += 1
        kind_rows.append(krow)
        mbi_rows.append(mrow)
        sidx_rows.append(srow)
        t += 1
        if t > 4 * v * (M + S) + 8:
            raise AssertionError(
                "interleaved forward schedule did not converge")
    # forward-only consumption is the fwd tick itself
    depth = _ring_depth(
        fwd_done, fwd_done, S, M, start=1,
        what=f"forward schedule (D={n_dev}, v={v}, M={M})")
    return (np.asarray(kind_rows, np.int32),
            np.asarray(mbi_rows, np.int32),
            np.asarray(sidx_rows, np.int32), depth)


def gpipe_schedule(S: int, M: int, training: bool = True):
    """The action table of a GPipe step over S stages on S devices:
    forward ticks t = 0 .. M + S - 2 (stage s runs microbatch t - s),
    then, in training, as many reverse ticks (stage s runs the backward
    of microbatch t' - (S - 1 - s)), the order in which JAX's autodiff
    transposes its forward scan. Returns (kind, mbi, sidx, depth) as
    :func:`interleaved_schedule` does."""
    T0 = M + S - 1
    T = 2 * T0 if training else T0
    kind = np.full((T, S), IDLE, np.int32)
    mbi = np.full((T, S), -1, np.int32)
    sidx = np.full((T, S), -1, np.int32)
    for t in range(T0):
        for d in range(S):
            if 0 <= t - d < M:
                kind[t, d], mbi[t, d], sidx[t, d] = FWD, t - d, d
            m = t - (S - 1 - d)
            if training and 0 <= m < M:
                kind[T0 + t, d], mbi[T0 + t, d], sidx[T0 + t, d] = \
                    BWD, m, d
    fwd_done, bwd_done = _done_ticks(kind, mbi, sidx, S, M)
    depth = _ring_depth(fwd_done, bwd_done if training else fwd_done,
                        S, M, start=1, what=f"gpipe (S={S}, M={M})")
    return kind, mbi, sidx, depth


def _done_ticks(kind, mbi, sidx, S: int, M: int):
    """(fwd_done, bwd_done)[stage][microbatch]: the tick each unit of a
    table runs at (-1: never)."""
    fwd = [[-1] * M for _ in range(S)]
    bwd = [[-1] * M for _ in range(S)]
    for t in range(kind.shape[0]):
        for d in range(kind.shape[1]):
            if kind[t, d] == FWD:
                fwd[sidx[t, d]][mbi[t, d]] = t
            elif kind[t, d] == BWD:
                bwd[sidx[t, d]][mbi[t, d]] = t
    return fwd, bwd


def _cotangent_depth(bwd_done, S: int, M: int) -> int:
    """The cotangent ring's depth: ct(s, m) lands one tick after
    bwd(s + 1, m) and is consumed by bwd(s, m) — the activation rule of
    :func:`_ring_depth` with the stages taken in reverse order."""
    rev = bwd_done[::-1]
    return _ring_depth(rev, rev, S, M, start=1, what="cotangent ring")


def _arrival_tables(kind, mbi, sidx, n_dev: int, S: int):
    """Per-(tick, device) wire-arrival tables (-1 mb = nothing arrived):
    stage s running fwd(m) at t-1 puts act(m) on stage s+1's device
    ((s+1) % n_dev, a +1 ring neighbour) at tick t, into that stage's
    chunk ((s+1) // n_dev) buffer; bwd cotangents mirror on the -1
    ring."""
    T = kind.shape[0]
    arr_f = np.full((T, n_dev), -1, np.int32)
    arrc_f = np.zeros((T, n_dev), np.int32)
    arr_b = np.full((T, n_dev), -1, np.int32)
    arrc_b = np.zeros((T, n_dev), np.int32)
    for t in range(1, T):
        for d in range(n_dev):
            s = int(sidx[t - 1, d])
            if kind[t - 1, d] == FWD and s < S - 1:
                rd = (s + 1) % n_dev
                arr_f[t, rd] = mbi[t - 1, d]
                arrc_f[t, rd] = (s + 1) // n_dev
            elif kind[t - 1, d] == BWD and s > 0:
                rd = (s - 1) % n_dev
                arr_b[t, rd] = mbi[t - 1, d]
                arrc_b[t, rd] = (s - 1) // n_dev
    return arr_f, arrc_f, arr_b, arrc_b


# --------------------------------------------------------------------------
# the wire and the stage runner
# --------------------------------------------------------------------------

def _is_float(dt: str) -> bool:
    return getattr(torch, dt).is_floating_point


def _wire_layouts(plan: StagePlan, model=None):
    """Per-cut flat layout (uid, dtype, offset, per-sample size, shape)
    and per-dtype widest hop. Under an active compute_dtype policy
    (core/precision.py) float cut tensors cross at the compute dtype:
    the stage activations are at that dtype already, and a wider wire
    would double the bytes of a hop and upcast the next stage."""
    from ..core import precision as MP
    wire_dt = None
    if model is not None and MP.policy_active(model.config):
        wire_dt = MP.dtype_name(model.config.compute_dtype)
    layouts = []
    widths: Dict[str, int] = {}
    for cut in plan.cuts:
        lay = []
        offsets: Dict[str, int] = {}
        for t in cut:
            dt = MP.dtype_name(t.dtype)
            if wire_dt is not None and _is_float(dt):
                dt = wire_dt
            size = int(np.prod(t.shape[1:]))  # per sample; dim 0 = batch
            off = offsets.get(dt, 0)
            lay.append((t.uid, dt, off, size, tuple(t.shape[1:])))
            offsets[dt] = off + size
        for dt, end in offsets.items():
            widths[dt] = max(widths.get(dt, 0), end)
        layouts.append(lay)
    if not widths:
        widths["float32"] = 1
    return layouts, widths


def _make_stage_runner(plan: StagePlan, model, layouts, mb_local: int, *,
                       training: bool, seq_length: int):
    """The body of one stage tick (JAX's ``_stage_core``): microbatch
    inputs and the incoming wire in, the stage's ops run in order, and
    out (wire {dtype: flat}, the final tensor at the last stage, the
    stage's aux loss or None, {op: state_out}). The i-th op of the stage
    draws from ``fold_in(mb_key, i)``; under the policy the weights and
    float inputs cast to the compute dtype here, inside whatever is
    differentiated, and the value stream stays at it."""
    from ..core import precision as MP
    from ..core.prng import OpRng
    S = plan.num_stages
    final_t = model.final_tensor
    uid_of = {t.name: t.uid for t in model.input_tensors}
    cdt = (model.config.compute_dtype if MP.policy_active(model.config)
           else None)

    def run_stage(s: int, params_s, wire_in, mb_in, mb_key, states_s):
        values: Dict[int, torch.Tensor] = {}
        for name, v in mb_in.items():
            if cdt is not None and MP.is_float_tensor(v) and v.dtype != cdt:
                v = v.to(cdt)
            values[uid_of[name]] = v
        if s > 0:
            for uid, dt, off, size, shape in layouts[s - 1]:
                values[uid] = wire_in[dt][off * mb_local:(off + size)
                                          * mb_local].view(
                    (mb_local,) + shape)
        if cdt is not None:
            params_s = MP.cast_floats(params_s, cdt)
        aux = None
        state_out = {}
        for i, op in enumerate(plan.stages[s]):
            ctx = OpContext(
                training=training, seq_length=seq_length,
                rng=OpRng(mb_key, i) if mb_key is not None else None,
                state_in=states_s.get(op.name))
            ys = op.forward(params_s.get(op.name, {}),
                            [values[t.uid] for t in op.inputs], ctx)
            if cdt is not None:
                ys = [y.to(cdt) if MP.is_float_tensor(y) and y.dtype != cdt
                      else y for y in ys]
            for t, y in zip(op.outputs, ys):
                values[t.uid] = y
            if ctx.aux_loss is not None:
                aux = ctx.aux_loss if aux is None else aux + ctx.aux_loss
            if ctx.state_out:
                state_out[op.name] = ctx.state_out
        wire_out: Dict[str, torch.Tensor] = {}
        if s < S - 1:
            parts: Dict[str, list] = {}
            for uid, dt, _off, _size, _shape in layouts[s]:
                parts.setdefault(dt, []).append(
                    values[uid].reshape(-1).to(getattr(torch, dt)))
            wire_out = {dt: torch.cat(p) for dt, p in parts.items()}
        final = (values[final_t.uid].to(_final_dtype(model)) if s == S - 1
                 else None)
        return wire_out, final, aux, state_out

    return run_stage


def _final_dtype(model) -> torch.dtype:
    """The dtype the last stage emits the final tensor in: f32 for a
    float final tensor under the precision policy (the losses and
    metrics read f32-upcast logits, the one-device executor's exempt
    region), else its declared dtype (JAX's)."""
    from ..core import precision as MP
    dt = model.final_tensor.dtype
    if MP.policy_active(model.config) and dt.is_floating_point:
        return torch.float32
    return dt


def _data_split(bm, data_axis: Optional[str], mb: int):
    """(data axis or None, n_data, mb_local): microbatches split over
    the data axis inside each stage when they divide, else every data
    rank runs them whole."""
    data_ax = (data_axis if data_axis and bm is not None
               and data_axis in bm.groups else None)
    ndata = bm.axis_size(data_ax) if data_ax else 1
    if mb % ndata != 0:
        data_ax, ndata = None, 1
    return data_ax, ndata, mb // ndata


# fault sites the tests plant faults in (a slot read, the objective's
# scale, a microbatch's gradient sum)
def _read_slot(c: int, m: int, depth: int) -> int:
    return c * depth + m % depth


def _objective_scale(M: int, ndata: int) -> float:
    from ..core.precision import reciprocal_f32
    return reciprocal_f32(M * ndata)


def _add_grads(acc: dict, names, grads) -> None:
    for (op, w, p), g in zip(names, grads):
        if g is None:
            continue
        cur = acc[op].get(w)
        g = g.to(p.dtype)
        acc[op][w] = g if cur is None else cur + g


# --------------------------------------------------------------------------
# the executing schedules
# --------------------------------------------------------------------------

def _execute(plan: StagePlan, model, bm, pipe_axis: str, ndata: int,
             M: int, params, states, inputs,
             rng, tables, *, training: bool, seq_length: int,
             remat: bool = False, loss_fn=None, label=None,
             metric_names: Sequence[str] = (), sparse_metrics=True,
             keep_outputs: bool = False) -> dict:
    """Run this rank's rows of a schedule table (kind, mbi, sidx, depth)
    and return its partial results: the last stage's outputs (its data
    rows, microbatch-major) when ``keep_outputs``, the sums of the
    microbatches' losses, aux losses and metric sums, the weight
    gradients of the rank's ops (summed over its microbatches, not over
    ``data``) and the peak in-flight microbatches of each of its
    stages. ``inputs``/``label`` hold the rank's rows, M microbatches of
    ``mb_local`` rows each (``ndata``: the data ranks a microbatch is
    split over); ``states`` ({op: {name: tensor}}) advance in place in
    training."""
    from ..core import metrics as MET
    from . import collectives as C
    S = plan.num_stages
    D = bm.axis_size(pipe_axis)
    d = bm.coord(pipe_axis)
    kind, mbi, sidx, depth = tables
    T = kind.shape[0]
    first = next(iter(inputs.values()))
    mb_local = first.shape[0] // M
    scale = _objective_scale(M, ndata)
    layouts, _ = _wire_layouts(plan, model)
    sizes = [{} for _ in layouts]           # cut -> {dtype: elements}
    for i, lay in enumerate(layouts):
        for _uid, dt, _off, size, _shape in lay:
            sizes[i][dt] = sizes[i].get(dt, 0) + size * mb_local
    runner = _make_stage_runner(plan, model, layouts, mb_local,
                                training=training, seq_length=seq_length)
    arr_f, arrc_f, arr_b, arrc_b = _arrival_tables(kind, mbi, sidx, D, S)
    _, bwd_done = _done_ticks(kind, mbi, sidx, S, M)
    ct_depth = _cotangent_depth(bwd_done, S, M) if training else 1
    inputs_mb = {k: v.reshape((M, mb_local) + tuple(v.shape[1:]))
                 for k, v in inputs.items()}
    label_mb = (label.reshape((M, mb_local) + tuple(label.shape[1:]))
                if label is not None else None)
    device = first.device
    by_stage = {s: {op.name: params[op.name] for op in plan.stages[s]
                    if op.name in params}
                for s in range(d, S, D)}
    st_stage = {s: {op.name: states[op.name] for op in plan.stages[s]
                    if op.name in states}
                for s in range(d, S, D)}
    grads = {op: {} for s in by_stage for op in by_stage[s]}
    act, act_owner = {}, {}
    ct, ct_owner = {}, {}
    saved = {}
    inflight = {s: 0 for s in by_stage}
    peak = {s: 0 for s in by_stage}
    outputs = [None] * M
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    aux_sum = torch.zeros((), dtype=torch.float32, device=device)
    met: Dict[str, torch.Tensor] = {}
    if metric_names and label_mb is not None:
        # every rank reduces the same named sums (zeros but on the last
        # stage): their names and dtypes from a one-row batch
        final_t = model.final_tensor
        with torch.no_grad():
            probe = MET.compute_metrics(
                metric_names, torch.zeros((1,) + tuple(final_t.shape[1:]),
                                          dtype=_final_dtype(model),
                                          device=device),
                label_mb[0][:1], sparse_metrics)
        met = {k: torch.zeros_like(v) for k, v in probe.items()}
    pending: list = []

    # the (chunk, microbatch) ring slots, allocated up front: the
    # activations of stage s's cut arrive in act, the cotangents of its
    # own cut in ct
    for s in by_stage:
        c = s // D
        for j in range(depth if s > 0 else 0):
            act[c * depth + j] = {dt: torch.zeros(
                n, dtype=getattr(torch, dt), device=device)
                for dt, n in sizes[s - 1].items()}
        for j in range(ct_depth if training and s < S - 1 else 0):
            ct[c * ct_depth + j] = {dt: torch.zeros(
                n, dtype=getattr(torch, dt), device=device)
                for dt, n in sizes[s].items() if _is_float(dt)}

    def deposit(ring, owner, key, m):
        if owner.get(key) is not None:
            raise AssertionError(
                f"pipeline ring slot {key} still holds microbatch "
                f"{owner[key]} when microbatch {m} arrives")
        owner[key] = m
        return ring[key]

    def fwd(s: int, m: int):
        c = s // D
        wire_in = {}
        if s > 0:
            raw = act[_read_slot(c, m, depth)]
            wire_in = {dt: (b.detach().requires_grad_(True)
                            if training and _is_float(dt) else b)
                       for dt, b in raw.items()}
            if not training:
                act_owner[c * depth + m % depth] = None
        mb_in = {k: v[m] for k, v in inputs_mb.items()}
        mkey = None
        if rng is not None:
            from ..core.prng import fold_in_tensor
            mkey = fold_in_tensor(rng, m)
        with torch.set_grad_enabled(training):
            if remat and training:
                from torch.utils.checkpoint import checkpoint
                out = checkpoint(runner, s, by_stage[s], wire_in, mb_in,
                                 mkey, st_stage[s], use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                out = runner(s, by_stage[s], wire_in, mb_in, mkey,
                             st_stage[s])
        wire_out, final, aux, st_out = out
        if training and st_out:
            with torch.no_grad():
                for op, sd in st_out.items():
                    for k, v in sd.items():
                        states[op][k].copy_(v)
        if s < S - 1:
            pending.extend(C.send_next(wire_out[dt].detach(), bm, pipe_axis)
                           for dt in sorted(wire_out))
        obj = None
        if aux is not None:
            aux_sum.add_(aux.detach().float())
            if training:
                obj = aux * scale
        if s == S - 1:
            if keep_outputs:
                outputs[m] = final.detach()
            if training and loss_fn is not None and label_mb is not None:
                lm = loss_fn(final, label_mb[m])
                loss_sum.add_(lm.detach().float())
                obj = lm * scale if obj is None else lm * scale + obj
            if metric_names and label_mb is not None:
                with torch.no_grad():
                    sums = MET.compute_metrics(metric_names, final.detach(),
                                               label_mb[m], sparse_metrics)
                for k, v in sums.items():
                    met[k] = met[k] + v
        if training:
            saved[(s, m)] = (obj, wire_out if s < S - 1 else {}, wire_in)
            inflight[s] += 1
            peak[s] = max(peak[s], inflight[s])

    def bwd(s: int, m: int):
        c = s // D
        obj, wire_out, wire_in = saved.pop((s, m))
        inflight[s] -= 1
        targets, gouts = [], []
        if s < S - 1:
            slot = _read_slot(c, m, ct_depth)
            cts = ct[slot]
            ct_owner[c * ct_depth + m % ct_depth] = None
            for dt in sorted(wire_out):
                if wire_out[dt].requires_grad:
                    targets.append(wire_out[dt])
                    gouts.append(cts[dt])
        if obj is not None and obj.requires_grad:
            targets.append(obj)
            gouts.append(torch.ones_like(obj))
        names = [(op, w, p) for op, ws in by_stage[s].items()
                 for w, p in ws.items()]
        leaves = [dt for dt in sorted(wire_in) if _is_float(dt)]
        srcs = [p for _, _, p in names] + [wire_in[dt] for dt in leaves]
        gs = (torch.autograd.grad(targets, srcs, gouts, allow_unused=True)
              if targets else [None] * len(srcs))
        _add_grads(grads, names, gs[:len(names)])
        if s > 0:
            act_owner[c * depth + m % depth] = None
            for dt, g in zip(leaves, gs[len(names):]):
                g = torch.zeros_like(wire_in[dt]) if g is None else g
                pending.append(C.send_prev(g.detach(), bm, pipe_axis))

    for t in range(T):
        ops, pending = pending, []
        m = int(arr_f[t, d])
        if m >= 0:
            c = int(arrc_f[t, d])
            bufs = deposit(act, act_owner, c * depth + m % depth, m)
            ops += [C.recv_prev(bufs[dt], bm, pipe_axis)
                    for dt in sorted(bufs)]
        m = int(arr_b[t, d])
        if m >= 0:
            c = int(arrc_b[t, d])
            bufs = deposit(ct, ct_owner, c * ct_depth + m % ct_depth, m)
            ops += [C.recv_next(bufs[dt], bm, pipe_axis)
                    for dt in sorted(bufs)]
        C.post(bm, ops)
        k = int(kind[t, d])
        if k == FWD:
            fwd(int(sidx[t, d]), int(mbi[t, d]))
        elif k == BWD:
            bwd(int(sidx[t, d]), int(mbi[t, d]))
    if pending or saved:
        raise AssertionError(f"pipeline schedule left {len(pending)} "
                             f"transfers and {len(saved)} microbatches")
    for op, ws in grads.items():
        for w, p in params[op].items():
            if w not in ws:
                ws[w] = torch.zeros_like(p.detach())
    return {"outputs": (torch.cat(outputs) if keep_outputs
                        and outputs[0] is not None else None),
            "loss_sum": loss_sum, "aux_sum": aux_sum, "metrics": met,
            "grads": grads, "peak": peak, "scale": scale,
            "ndata": ndata}


def _reduce_scalars(bm, pipe_axis, data_ax, values: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Sum named scalars over ``data`` (when the microbatches split over
    it) and over ``pipe``, in one float64 all-reduce each; each keeps
    its dtype."""
    from . import collectives as C
    names = sorted(values)
    if not names:
        return {}
    vec = torch.stack([values[n].double().reshape(()) for n in names])
    if data_ax is not None:
        C.all_reduce_(vec, bm, data_ax)
    C.all_reduce_(vec, bm, pipe_axis)
    return {n: vec[i].to(values[n].dtype) for i, n in enumerate(names)}


def _last_coord(S: int, D: int) -> int:
    return (S - 1) % D


def rank_split(model, bm, data_axis: Optional[str], M: int):
    """(data axis or None, n_data, mb_local) of a pipelined step of
    ``model``'s (global) batch in M microbatches: JAX's
    ``_data_split`` of its microbatch."""
    B = int(model.input_tensors[0].shape[0])
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    return _data_split(bm, data_axis, B // M)


def _check_rows(inputs, M: int, mb_local: int, data_ax):
    for name, v in inputs.items():
        if v.shape[0] != M * mb_local:
            raise ValueError(
                f"{name!r}: {v.shape[0]} rows where this rank runs {M} "
                f"microbatches of {mb_local} rows"
                + (f" (its rows of each microbatch over {data_ax!r})"
                   if data_ax else ""))


def pipeline_grads(plan: StagePlan, params, inputs: Dict[str, torch.Tensor],
                   label, loss_fn, rng, bm, pipe_axis: str,
                   data_axis: Optional[str], num_microbatches: int, model,
                   *, seq_length: int = -1, schedule: str = "gpipe",
                   states=None, metric_names: Sequence[str] = (),
                   sparse_metrics: bool = True,
                   remat: bool = False) -> dict:
    """One pipelined training step on this rank (``inputs`` and
    ``label``: the rank's rows, M microbatches of ``mb_local`` rows,
    microbatch-major). Returns {"loss": the global batch's loss plus the
    aux losses (the same on every rank), "metrics": the global metric
    sums, "grads": the weight gradients of the rank's ops — summed over
    its microbatches, not over ``data`` (the caller syncs them) —,
    "peak": in-flight microbatches by stage}. ``states`` advance per
    microbatch in order at the forward ticks and end as their mean over
    ``data``. ``remat`` (GPipe) recomputes each stage tick in the
    backward (torch.utils.checkpoint)."""
    from . import collectives as C
    from ..core.precision import reciprocal_f32
    S = plan.num_stages
    M = int(num_microbatches)
    D = bm.axis_size(pipe_axis)
    if S % D:
        raise ValueError(f"{S} stages do not divide over the {D}-device "
                         f"{pipe_axis!r} axis")
    data_ax, ndata, mb_local = rank_split(model, bm, data_axis, M)
    _check_rows(inputs, M, mb_local, data_ax)
    layouts, widths = _wire_layouts(plan, model)
    if schedule == "1f1b":
        for dt in widths:
            if not _is_float(dt):
                raise NotImplementedError(
                    f"1F1B: non-float tensor (dtype {dt}) crosses a stage "
                    f"boundary; cotangent wires need float dtypes — use "
                    f"the gpipe schedule")
        tables = interleaved_schedule(D, S // D, M)
    elif schedule == "gpipe":
        if S != D:
            raise ValueError(f"{S} stages over {D} devices = interleaved "
                             f"execution, which requires the 1f1b "
                             f"schedule")
        tables = gpipe_schedule(S, M)
    else:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    states = states if states is not None else {}
    res = _execute(plan, model, bm, pipe_axis, ndata, M, params,
                   states, inputs, rng, tables, training=True,
                   seq_length=seq_length,
                   remat=remat and schedule == "gpipe", loss_fn=loss_fn,
                   label=label, metric_names=metric_names,
                   sparse_metrics=sparse_metrics)
    red = _reduce_scalars(bm, pipe_axis, data_ax, {
        "__loss__": res["loss_sum"], "__aux__": res["aux_sum"],
        **res["metrics"]})
    loss = (red.pop("__loss__") * res["scale"]
            + red.pop("__aux__") * res["scale"]).float()
    if data_ax is not None and states:
        # per-shard statistics (DDP BatchNorm), their mean over data
        inv = reciprocal_f32(ndata)
        with torch.no_grad():
            for op in {op.name for s in range(bm.coord(pipe_axis), S, D)
                       for op in plan.stages[s]} & set(states):
                for v in states[op].values():
                    C.all_reduce_(v, bm, data_ax)
                    v.mul_(inv)
    return {"loss": loss, "metrics": red, "grads": res["grads"],
            "peak": res["peak"], "data_axis": data_ax}


def _forward_only(plan, params, inputs, rng, bm, pipe_axis, data_axis,
                  num_microbatches, model, tables, *, training,
                  seq_length, states):
    from . import collectives as C
    from ..core.precision import reciprocal_f32
    S = plan.num_stages
    M = int(num_microbatches)
    D = bm.axis_size(pipe_axis)
    data_ax, ndata, mb_local = rank_split(model, bm, data_axis, M)
    _check_rows(inputs, M, mb_local, data_ax)
    res = _execute(plan, model, bm, pipe_axis, ndata, M, params,
                   states if states is not None else {}, inputs, rng,
                   tables, training=training, seq_length=seq_length,
                   keep_outputs=True)
    aux = _reduce_scalars(bm, pipe_axis, data_ax,
                          {"aux": res["aux_sum"]})["aux"]
    aux = (aux * reciprocal_f32(M * ndata)).float()
    logits = res["outputs"]
    if logits is None:
        logits = torch.zeros((M * mb_local,)
                             + tuple(model.final_tensor.shape[1:]),
                             dtype=_final_dtype(model),
                             device=next(iter(inputs.values())).device)
    return C.broadcast_from(logits, bm, pipe_axis, _last_coord(S, D)), aux


def pipeline_logits(plan: StagePlan, params, inputs: Dict[str, torch.Tensor],
                    rng, bm, pipe_axis: str, data_axis: Optional[str],
                    num_microbatches: int, model, *, training: bool = False,
                    seq_length: int = -1, states=None):
    """The GPipe forward ticks over ``pipe_axis`` (tick t, stage s runs
    microbatch t - s), forward only: (logits of the rank's rows, the
    aux loss: the mean over microbatches and data shards). The last
    stage's outputs reach every pipe rank (JAX's psum over ``pipe``)."""
    S = plan.num_stages
    if S != bm.axis_size(pipe_axis):
        raise ValueError(f"pipeline_logits runs one stage a device; "
                         f"{S} stages on {bm.axis_size(pipe_axis)}: use "
                         f"pipeline_logits_interleaved")
    return _forward_only(plan, params, inputs, rng, bm, pipe_axis,
                         data_axis, num_microbatches, model,
                         gpipe_schedule(S, int(num_microbatches),
                                        training=False),
                         training=training, seq_length=seq_length,
                         states=states)


def pipeline_logits_interleaved(plan: StagePlan, params, inputs, rng, bm,
                                pipe_axis: str, data_axis: Optional[str],
                                num_microbatches: int, model, *,
                                training: bool = False,
                                seq_length: int = -1, states=None):
    """Forward-only run of an interleaved layout (S = v D stages, stage
    s on pipe coordinate s mod D) on the forward-only interleaved
    schedule: the evaluation counterpart of
    ``pipeline_grads(schedule="1f1b")`` (JAX's ``pipeline_1f1b_grads``).
    Returns (logits, aux) as
    :func:`pipeline_logits` does."""
    S = plan.num_stages
    D = bm.axis_size(pipe_axis)
    if S % D:
        raise ValueError(f"{S} stages do not divide over the {D}-device "
                         f"{pipe_axis!r} axis")
    return _forward_only(plan, params, inputs, rng, bm, pipe_axis,
                         data_axis, num_microbatches, model,
                         interleaved_forward_schedule(
                             D, S // D, int(num_microbatches)),
                         training=training, seq_length=seq_length,
                         states=states)


# --------------------------------------------------------------------------
# analytics
# --------------------------------------------------------------------------

def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """GPipe bubble: idle fraction of each device's timeline."""
    S, M = num_stages, num_microbatches
    return (S - 1) / (M + S - 1)


def simulate_step_scaling(num_stages: int, m_a: int, m_b: int) -> float:
    """Predicted step-time ratio time(M=m_a)/time(M=m_b) at fixed global
    batch: per-microbatch work scales 1/M, ticks = M + S - 1, so step
    time ∝ (M + S - 1)/M. The measurable form of the bubble model (the
    sim-vs-measured agreement tests hold CPU-mesh timings against it)."""
    S = num_stages
    return ((m_a + S - 1) / m_a) / ((m_b + S - 1) / m_b)


def peak_microbatches(num_stages: int, num_microbatches: int,
                      schedule: str) -> int:
    """Peak in-flight microbatches whose activations a stage must hold:
    GPipe stores all M before backward drains; 1F1B caps at S."""
    if schedule == "1f1b":
        return min(num_stages, num_microbatches)
    return num_microbatches
