"""Pipeline planning over arbitrary op graphs: the planner half of
``flexflow_tpu/parallel/graph_pipeline.py``.

What the strategy simulator reads, and no execution:

  * ``StagePlan``, ``build_stage_plan`` — a partition of the op graph
    into S contiguous stages with the cut tensors each inter-stage hop
    carries; ``balanced_stages`` (flops-balanced auto-cut),
    ``assignment_from_pins`` (stages from a strategy's whole-op device
    pins) and ``pick_pipe_axis``;
  * the schedule tables ``one_f_one_b_schedule`` and
    ``interleaved_schedule`` (``FWD``/``BWD``/``IDLE`` per tick and
    device), ``schedule_bubble`` and ``bubble_fraction``, which the
    simulator's 1F1B tick pricing runs on.

The executing half — parameter packing, ``pipeline_logits`` and
``pipeline_1f1b_grads`` over a mesh's pipe axis — waits for ROADMAP
module item 2.3; ``FFModel.compile`` raises for ``pipeline_stages > 1``
until then.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..op import Op

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
