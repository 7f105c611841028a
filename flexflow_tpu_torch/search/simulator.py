"""Event-driven execution simulator: ``flexflow_tpu/search/simulator.py``,
whole.

The training half (``SimTask``, ``TaskGraph``, ``op_edges``,
``Simulator``) builds a task graph (forward, backward, collective,
gradient-sync and update tasks) for a candidate strategy on a mesh
description and runs a priority-queue event loop over contended
resources (the compute stream, the interconnect, per-device and
per-stage rows): overlap-exact gradient sync and bucket pricing
(``FFConfig.grad_bucket_mb``, core/overlap.py), staged and 1F1B tick
pricing of graph pipelines, fusion folding, the exact delta
re-simulation the search anneals with (``simulate_delta``), calibration
against a measured step (``calibrate_end_to_end``), grounding in
measured ops (``measured_adjust``, search/op_measure.py), and the
Perfetto and DOT exports. The serve half runs the ONE mixed serving
step's task graph (cost_model.serve_step_tasks) to its critical path.

The event loop, the formulas and their float order are the JAX
package's, so on the same machine numbers both packages simulate the
same seconds. Memory over the device's capacity pays the machine
model's penalty (1 ms per MB).
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
from typing import Dict, List, Optional

from ..parallel.pconfig import Strategy
from . import machine_model as _machine
from .cost_model import OpCost, op_cost
from .machine_model import H100MachineModel


@functools.lru_cache(maxsize=256)
def _schedule_tables(n_dev: int, v: int, M: int):
    """Memoized 1F1B/interleaved schedule tables (pure function of the
    triple; the annealing loop reprices thousands of candidates)."""
    from ..parallel.graph_pipeline import interleaved_schedule
    return interleaved_schedule(n_dev, v, M)


@dataclasses.dataclass
class SimTask:
    name: str
    duration: float
    resource: object            # one hashable key ("compute"/"comm"/
    # ("stage", u, k)) or a LIST of keys the task occupies simultaneously
    # (a placed op's device set; an SPMD op holding every device)
    deps: List["SimTask"] = dataclasses.field(default_factory=list)
    # runtime state
    unresolved: int = 0
    ready_time: float = 0.0
    finish_time: float = 0.0
    # schedule recording (simulate(record=True) only): the task's
    # scheduled start (the event loop's exact float, NOT finish -
    # duration, which re-rounds) and what bound it — the dep that set
    # its ready time, or the previous occupant of its resource —
    # walked backward for the critical path
    start_time: float = 0.0
    blocker: object = None
    ready_by: object = None


class TaskGraph:
    def __init__(self):
        self.tasks: List[SimTask] = []

    def add(self, name, duration, resource, deps=()):
        t = SimTask(name=name, duration=duration, resource=resource,
                    deps=list(deps))
        self.tasks.append(t)
        return t

    def simulate(self, record: bool = False) -> float:
        """Priority-queue event loop (reference simulator.cc:499-554).
        A task may occupy several resources at once (tuple resource) —
        this is how per-device concurrency is modeled: ops bound to
        disjoint device sets proceed in parallel, overlapping sets
        serialize (reference: per-device task queues in slice_task).

        ``record=True`` additionally stamps each task's binding
        constraint (``blocker``: the dep that set its ready time, or
        the resource's previous occupant when the task waited on the
        resource instead) so :meth:`critical_path` can walk the chain
        that determined the makespan. The recording branch is gated so
        the annealing hot path pays nothing for it."""
        children: Dict[int, List[SimTask]] = {}
        for t in self.tasks:
            t.unresolved = len(t.deps)
            for d in t.deps:
                children.setdefault(id(d), []).append(t)
        free: Dict[object, float] = {}
        last_occupant: Dict[object, SimTask] = {}
        counter = 0
        q = []
        for t in self.tasks:
            if t.unresolved == 0:
                heapq.heappush(q, (t.ready_time, counter, t))
                counter += 1
        makespan = 0.0
        done = 0
        while q:
            ready, _, t = heapq.heappop(q)
            if t.duration == 0.0:
                # zero-duration tasks are transparent: they neither
                # consult nor occupy their resource. Provably identical
                # to the occupy-path for every graph this file builds
                # (a zero-duration task can never raise free[k] above
                # any later pop's ready time, since pops are ordered by
                # ready time), and it makes a materialized zero-cost
                # comm/sync task exactly equivalent to no task — the
                # invariant the delta-simulation template relies on.
                t.finish_time = ready
                if record:
                    t.start_time = ready
                    t.blocker = t.ready_by
            else:
                keys = t.resource if isinstance(t.resource, list) \
                    else (t.resource,)
                start = max([ready] + [free.get(k, 0.0) for k in keys])
                t.finish_time = start + t.duration
                if record:
                    t.start_time = start
                    t.blocker = t.ready_by
                    if start > ready or t.ready_by is None:
                        for k in keys:
                            if free.get(k, 0.0) == start \
                                    and k in last_occupant:
                                t.blocker = last_occupant[k]
                                break
                    for k in keys:
                        last_occupant[k] = t
                for k in keys:
                    free[k] = t.finish_time
            makespan = max(makespan, t.finish_time)
            done += 1
            for c in children.get(id(t), []):
                if t.finish_time >= c.ready_time:
                    c.ready_time = t.finish_time
                    if record:
                        c.ready_by = t
                c.unresolved -= 1
                if c.unresolved == 0:
                    heapq.heappush(q, (c.ready_time, counter, c))
                    counter += 1
        assert done == len(self.tasks), "cycle in task graph"
        return makespan

    def critical_path(self) -> set:
        """ids of the tasks on the chain that determined the makespan
        (valid after simulate(record=True)): start at the last-finishing
        task and walk each task's binding constraint backward."""
        if not self.tasks:
            return set()
        t = max(self.tasks, key=lambda x: x.finish_time)
        crit = set()
        while t is not None and id(t) not in crit:
            crit.add(id(t))
            t = t.blocker
        return crit

    def export_dot(self, path: str) -> None:
        """Taskgraph DOT export (reference --taskgraph, simulator.h DotFile)."""
        with open(path, "w") as f:
            f.write("digraph taskgraph {\n")
            ids = {id(t): i for i, t in enumerate(self.tasks)}
            for t in self.tasks:
                f.write(f'  t{ids[id(t)]} [label="{t.name}\\n'
                        f'{t.duration*1e6:.1f}us ({t.resource})"];\n')
            for t in self.tasks:
                for d in t.deps:
                    f.write(f"  t{ids[id(d)]} -> t{ids[id(t)]};\n")
            f.write("}\n")


def _axis_sig(s) -> tuple:
    """Hashable signature of one op's axis map — the in-memory cost-cache
    key and the delta template's change detector."""
    return tuple(sorted((k, str(v)) for k, v in s.axis_map.items()))


def _res_label(res) -> str:
    """Human label of one simulator resource key."""
    if isinstance(res, list):
        if "compute" in res:
            return "compute"
        return "dev " + ",".join(str(k[1]) for k in res)
    if isinstance(res, tuple):
        if res[0] == "dev":
            return f"dev {res[1]}"
        if res[0] == "stage":
            return f"{res[1]} stage {res[2]}"
        return " ".join(str(p) for p in res)
    return str(res)


def _res_track(res):
    """(process, thread) track of a simulator resource — one Perfetto
    row per contended resource, so a task's placement in the trace IS
    its placement in the event loop ("comm" renders as the ICI
    fabric row)."""
    if res == "comm":
        return ("sim", "ici")
    return ("sim", _res_label(res))


def op_edges(model):
    """(producer-map, producer->consumer op pairs) in canonical order:
    iteration over each op's inputs.  Every engine that walks the graph
    (this simulator, the Python MCMC loop, the native search lowering)
    MUST derive edges through this one function — backward-dependency
    construction and propagation moves depend on the exact order."""
    producer = {}
    for op in model.ops:
        for t in op.outputs:
            producer[t.uid] = op
    edges = []
    for op in model.ops:
        for t in op.inputs:
            if t.uid in producer:
                edges.append((producer[t.uid], op))
    return producer, edges


@dataclasses.dataclass
class _BuiltGraph:
    """One _build_graph result: the task graph plus the metadata the
    delta path needs to capture a reusable template."""
    graph: TaskGraph
    total_mem: float
    costs: Dict[str, OpCost]
    slots: Dict[str, Dict[str, SimTask]]   # op -> component -> task
    expanded: set                          # pipeline-expanded units
    placed: dict                           # device-placed units
    # bucketed grad sync (grad_bucket_mb > 0): member names per bucket
    # (walk order) and the bucket sync tasks, [] when off
    bucket_members: list = dataclasses.field(default_factory=list)
    bucket_tasks: list = dataclasses.field(default_factory=list)


_SLOT_NAMES = ("fwd_comm", "fwd", "bwd_comm", "bwd", "sync")


class _DeltaTemplate:
    """Flattened scheduled task graph for delta re-simulation (the
    paper's delta simulation algorithm: keep the task graph of the
    current strategy, re-cost only changed ops, re-run the event loop
    over the cached arrays instead of rebuilding anything). Replaying
    the heap loop over these arrays reproduces TaskGraph.simulate
    bit-for-bit — same tie-breaking, same zero-duration transparency —
    so the delta path is EXACT, not an approximation; the drift counter
    exists to prove that at runtime, not to paper over error."""

    __slots__ = ("durations", "children", "ndeps0", "roots", "res",
                 "n_res", "op_slots", "op_sig", "op_class", "op_mem",
                 "op_order", "op_sync_bytes", "bucket_of",
                 "bucket_members", "bucket_slot")


@dataclasses.dataclass
class _DeltaToken:
    """Result of one simulate_delta call: the simulated step seconds
    plus the undo record delta_reject applies when the move loses —
    (per-op splices, bucket-task splices)."""
    cost: float
    undo: tuple


class Simulator:
    def __init__(self, model, mesh, mm: Optional[H100MachineModel] = None,
                 overlap_backward_sync: Optional[bool] = None):
        self.model = model
        self.mesh = mesh
        self.mm = mm or _machine.default_machine_model(mesh)
        # overlap modeling resolves from the config unless the caller
        # pins it (legacy constructor-only behavior): the SAME knob the
        # CLI exposes (--no-overlap-sync) so a flip reaches both the
        # task-graph shape and the cost-cache fingerprint below
        self._overlap_arg = overlap_backward_sync
        cfg = getattr(model, "config", None)
        self.overlap = (bool(getattr(cfg, "search_overlap_backward_sync",
                                     True))
                        if overlap_backward_sync is None
                        else bool(overlap_backward_sync))
        # the runtime's bucketed-sync config (core/overlap.py): priced
        # only under overlap (a serialized monolithic sync has no
        # buckets to hide). Resolved through the SAME resolve_bucket_mb
        # the executor uses (None = auto from the machine model for
        # this mesh), so the simulator prices the partition the
        # executor would actually deliver on this mesh and the cost
        # cache is keyed by the RESOLVED value (overlap_sig).
        from ..core.overlap import resolve_bucket_mb
        self.bucket_mb = resolve_bucket_mb(cfg, model, mesh=mesh)
        self._cache: Dict[tuple, OpCost] = {}
        # global multiplier calibrated from one real measured step
        # (calibrate_end_to_end); scales predictions without changing the
        # relative ordering the search depends on.
        self.time_scale = 1.0
        # calibrated fixed dispatch cost added once per simulated step
        # (strategy-independent; never changes the ranking)
        self.step_overhead = self.mm.efficiency.get("step_overhead_s", 0.0)
        # strategy-independent graph maps, built once (the annealing loop
        # calls simulate() thousands of times)
        self._producer, _ = op_edges(model)
        self._ops_by_name = {op.name: op for op in model.ops}
        # fused-unit partition + edges per strategy signature (fusion
        # groups depend only on each op's axis map)
        self._unit_cache: Dict[tuple, tuple] = {}
        # staged-pipeline candidate caches (previously created lazily via
        # getattr; proper __init__ state so invalidate() can clear them)
        self._balanced_cache: Dict[tuple, object] = {}
        self._staged_cost_cache: Dict[tuple, tuple] = {}
        self._staged_vstages = 1
        # delta-simulation template (simulate_delta); None until a
        # delta_rebase() established one for the current base strategy
        self._delta: Optional[_DeltaTemplate] = None
        # last record=True event-loop graph (export_schedule)
        self._last_graph: Optional[TaskGraph] = None
        # search instrumentation, rendered by profiling.search_report
        self.stats: Dict[str, int] = {
            "full_sims": 0, "delta_sims": 0, "delta_fallbacks": 0,
            "drift_resyncs": 0, "cost_mem_hits": 0, "cost_disk_hits": 0,
            "cost_computes": 0,
        }
        # persistent per-op cost cache, keyed by (op signature, axis-map
        # signature, machine-model fingerprint); shared process-wide
        cfg = getattr(model, "config", None)
        self._disk = None
        self._fingerprint = None
        if getattr(cfg, "search_cost_cache", True):
            from .cost_cache import CostCache, machine_fingerprint
            self._disk = CostCache.open(
                getattr(cfg, "cost_cache_file", None) or None)
            self._fingerprint = machine_fingerprint(
                self.mm, mesh, precision=self._precision(),
                overlap=self.overlap_sig())
        self._op_sig_memo: Dict[str, str] = {}
        self._cfg_sig = self._compute_cfg_sig()
        # per-op measured grounding (FFConfig.measure_top_ops)
        self._measured_set: set = self._choose_measured_ops()

    def overlap_sig(self):
        """(overlap flag, grad_bucket_mb) — the sync-overlap half of
        the machine fingerprint (cost_cache.machine_fingerprint); tools
        stamping fingerprints next to simulated numbers pass this so
        their stamps match the simulator's cache scope."""
        return (bool(self.overlap), float(self.bucket_mb))

    def _precision(self):
        """(compute_dtype, param_dtype) names of the model's policy —
        folded into the machine fingerprint so cached costs priced
        under one precision can never serve a search under another."""
        import torch

        from ..core.precision import dtype_name
        cfg = getattr(self.model, "config", None)
        if cfg is None:
            return ("float32", "float32")
        return (dtype_name(getattr(cfg, "compute_dtype", torch.float32)),
                dtype_name(getattr(cfg, "param_dtype", torch.float32)))

    def _compute_cfg_sig(self) -> tuple:
        """Config/optimizer facts op_cost reads beyond the op + strategy
        (embedding sparse-update eligibility) — part of the persistent
        cache key so a flag flip can't resurrect stale entries."""
        cfg = getattr(self.model, "config", None)
        opt = getattr(self.model, "optimizer", None)
        mode = None
        if opt is not None:
            try:
                mode = opt.sparse_mode()
            except Exception:
                mode = None
        return (bool(getattr(cfg, "sparse_embedding_updates", True)),
                bool(getattr(cfg, "sparse_embedding_lazy", False)),
                str(mode)) + self._precision()

    def invalidate(self) -> None:
        """Drop every derived cache (op costs, fused units, staged
        tables, the delta template) — call after mutating the machine
        model, config cost knobs, or the optimizer. The persistent disk
        store is not cleared; entries are re-keyed via the fingerprint
        and config signature instead."""
        self._cache.clear()
        self._unit_cache.clear()
        self._balanced_cache.clear()
        self._staged_cost_cache.clear()
        self._delta = None
        self._op_sig_memo.clear()
        self._cfg_sig = self._compute_cfg_sig()
        cfg = getattr(self.model, "config", None)
        if self._overlap_arg is None:
            self.overlap = bool(getattr(
                cfg, "search_overlap_backward_sync", True))
        from ..core.overlap import resolve_bucket_mb
        self.bucket_mb = resolve_bucket_mb(cfg, self.model,
                                           mesh=self.mesh)
        if self._disk is not None:
            from .cost_cache import machine_fingerprint
            self._fingerprint = machine_fingerprint(
                self.mm, self.mesh, precision=self._precision(),
                overlap=self.overlap_sig())
        self._measured_set = self._choose_measured_ops()

    def flush_cost_cache(self) -> None:
        if self._disk is not None:
            self._disk.flush()

    def search_stats(self) -> Dict[str, object]:
        """Counter snapshot plus shared-cache state for search_report."""
        out: Dict[str, object] = dict(self.stats)
        if self._disk is not None:
            out["disk_cache"] = self._disk.stats()
            out["fingerprint"] = self._fingerprint
        ci = _schedule_tables.cache_info()
        out["schedule_tables"] = {
            "hits": ci.hits, "misses": ci.misses,
            "currsize": ci.currsize, "maxsize": ci.maxsize}
        return out

    def calibrate_end_to_end(self, strategy: Strategy,
                             measured_step_seconds: float) -> float:
        """Set time_scale so the *step-time* part of simulate(strategy)
        equals the measured step time (the memory penalty is excluded
        from scaling, and the calibrated fixed dispatch overhead is
        subtracted from the measurement first) — the TPU analog of the
        reference grounding its model in real kernel measurements.
        Returns the scale applied."""
        raw, _penalty = self._simulate_raw(strategy)
        if measured_step_seconds <= self.step_overhead:
            # overhead-bound step: subtracting would zero the scale and
            # make every strategy simulate identically — drop the
            # overhead split and scale against the whole measurement
            import warnings
            warnings.warn(
                f"measured step ({measured_step_seconds*1e6:.0f}us) is "
                f"within the calibrated dispatch overhead "
                f"({self.step_overhead*1e6:.0f}us); calibrating without "
                f"the overhead split")
            self.step_overhead = 0.0
        if raw > 0:
            self.time_scale = (measured_step_seconds
                               - self.step_overhead) / raw
        return self.time_scale

    def _op_cost(self, op, strategy: Strategy) -> OpCost:
        """Per-(op, op-strategy) cost with caching (the analog of the
        reference's hash-keyed measurement cache, simulator.cc:301-321).
        With FFConfig.measure_top_ops > 0, the top-N ops by analytic
        time get their fwd/bwd REPLACED by isolated-op measurements on
        the card at the strategy's data-sharded sub-shape (op_measure.py — the
        reference's measure_operator_cost, model.cu:20-62); residual
        non-sample shardings still divide analytically.

        Three tiers: in-memory dict -> persistent disk store (keyed by
        op signature + axis map + machine fingerprint, cost_cache.py)
        -> compute. The disk tier is what lets repeated searches and
        mesh-shape sweeps in NEW processes skip re-deriving (and, under
        measure_top_ops, re-measuring) every cost."""
        s = strategy.for_op(op.name)
        return self._op_cost_for(op, s, _axis_sig(s))

    def _op_cost_for(self, op, s, sig) -> OpCost:
        key = (op.name, sig)
        c = self._cache.get(key)
        if c is not None:
            self.stats["cost_mem_hits"] += 1
            return c
        dkey = None
        if self._disk is not None:
            from .cost_cache import CostCache
            osig = self._op_sig_memo.get(op.name)
            if osig is None:
                from .op_measure import op_signature
                osig = self._op_sig_memo[op.name] = op_signature(op, 1)
            dkey = CostCache.entry_key(
                osig, sig,
                self._cfg_sig + (op.name in self._measured_set,))
            c = self._disk.get(self._fingerprint, dkey)
        if c is None:
            c = self.measured_adjust(op, s,
                                     op_cost(op, s, self.mesh, self.mm))
            self.stats["cost_computes"] += 1
            if dkey is not None:
                self._disk.put(self._fingerprint, dkey, c)
        else:
            self.stats["cost_disk_hits"] += 1
        self._cache[key] = c
        return c

    def measured_adjust(self, op, s, c: OpCost) -> OpCost:
        """Replace analytic fwd/bwd with measured seconds for grounded
        ops (measure_top_ops). Measurement happens at the sample-sharded
        sub-shape WHEN the sample axis genuinely divides; every other
        sharding axis divides the measured time analytically. Pipelined
        meta-ops and device-pinned ops keep their analytic expansion.
        Shared by the Python cache and the native engine's cost table
        (native_search.py) so both rank on the same grounded numbers."""
        if op.name not in self._measured_set or s.device_ids \
                or c.pipeline is not None:
            return c
        from .cost_model import compute_shards
        from .op_measure import CONV_CHAIN_TYPES, measure_op
        from ..parallel.pconfig import OpStrategy
        shards_total = compute_shards(op, s, self.mesh)
        s_nosample = OpStrategy({k: v for k, v in s.axis_map.items()
                                 if k != "sample"})
        resid = max(1, compute_shards(op, s_nosample, self.mesh))
        sample_div = max(1, shards_total // resid)
        m = measure_op(op, sample_shard=sample_div)
        if m is None:
            return c
        # conv-chain ops carry the per-device-kind in-situ correction:
        # isolated microbenchmarks under-predict in-graph conv cost
        # (op_measure.conv_in_situ_factor; VERDICT r4 #5)
        f = 1.0
        if op.op_type in CONV_CHAIN_TYPES:
            from .op_measure import conv_in_situ_factor
            f = conv_in_situ_factor()
        return dataclasses.replace(c, fwd=m["fwd"] * f / resid,
                                   bwd=m["bwd"] * f / resid)

    def _choose_measured_ops(self) -> set:
        """Ops covered by the top-N measurement SIGNATURES (shape
        classes) by aggregate analytic time. The cost cap is the
        measurements, and measure_op memoizes per signature — so N
        signatures can ground far more than N ops (Inception's ~100
        convs share a handful of shapes; capping op count left most of
        the model analytic). Pipeline meta-ops are excluded: one timing
        of the whole stack would be the giant compile this cap exists
        to avoid, and it would drop the bubble factor."""
        n = int(getattr(self.model.config, "measure_top_ops", 0) or 0)
        if n <= 0:
            return set()
        from .op_measure import op_signature
        seed = Strategy()
        by_sig: Dict[str, list] = {}
        sig_time: Dict[str, float] = {}
        for op in self.model.ops:
            if op.op_type == "pipeline_blocks":
                continue
            c = op_cost(op, seed.for_op(op.name), self.mesh, self.mm)
            sig = op_signature(op, 1)
            by_sig.setdefault(sig, []).append(op.name)
            sig_time[sig] = sig_time.get(sig, 0.0) + c.fwd + c.bwd
        top = sorted(sig_time, key=sig_time.get, reverse=True)[:n]
        return {name for sig in top for name in by_sig[sig]}

    def _units_for(self, strategy: Strategy):
        """(groups, unit_deps, unit_consumers) for this strategy's fusion
        partition, cached on the per-op axis-map signature (the annealing
        loop revisits the same few candidates thousands of times)."""
        if getattr(self.model.config, "perform_fusion", False):
            sig = tuple(
                tuple(sorted((k, str(v)) for k, v in
                             strategy.for_op(op.name).axis_map.items()))
                for op in self.model.ops)
        else:
            sig = ()
        if sig in self._unit_cache:
            return self._unit_cache[sig]
        if sig == ():
            groups = [[op.name] for op in self.model.ops]
        else:
            from ..core.fusion import compute_fusion_groups
            groups = compute_fusion_groups(self.model, strategy)
        unit_of = {m: g[-1] for g in groups for m in g}
        unit_deps: Dict[str, List[str]] = {g[-1]: [] for g in groups}
        unit_consumers: Dict[str, List[str]] = {}
        for grp in groups:
            uid_ = grp[-1]
            seen = set()
            for m in grp:
                for t in self._ops_by_name[m].inputs:
                    p = self._producer.get(t.uid)
                    if p is None:
                        continue
                    pu = unit_of[p.name]
                    if pu != uid_ and pu not in seen:
                        seen.add(pu)
                        unit_deps[uid_].append(pu)
                        unit_consumers.setdefault(pu, []).append(uid_)
        self._unit_cache[sig] = (groups, unit_deps, unit_consumers)
        return self._unit_cache[sig]

    def simulate(self, strategy: Strategy,
                 dot_path: Optional[str] = None) -> float:
        """Estimated seconds per training step under `strategy`. The
        calibrated fixed dispatch cost (measure_step_overhead) is added
        once per step — strategy-independent, so it never changes the
        ranking, only absolute accuracy."""
        self.stats["full_sims"] += 1
        step_time, penalty = self._simulate_raw(strategy, dot_path)
        return step_time * self.time_scale + penalty + self.step_overhead

    def _staged_assignment(self, strategy: Strategy):
        """op->stage map when this strategy executes as a graph
        pipeline (mirrors model.compile's lowering decision: whole-op
        pins on non-embedding ops, or config.pipeline_stages), else
        None."""
        from ..parallel.graph_pipeline import (
            assignment_from_pins, balanced_stages, build_stage_plan,
            pick_pipe_axis)

        def viable(stage_of, vstages=1):
            if stage_of is None or max(stage_of.values()) < 1:
                return None
            n_stages = max(stage_of.values()) + 1
            # interleaved auto-cut: the pipe axis carries
            # n_stages / vstages devices (compile's lowering,
            # model.py pipeline_virtual_stages)
            if vstages > 1 and n_stages % vstages != 0:
                return None
            if pick_pipe_axis(self.mesh,
                              n_stages // max(1, vstages)) is None:
                return None  # compile would warn + replicate
            try:
                build_stage_plan(self.model, stage_of)
            except (ValueError, NotImplementedError):
                return None
            return stage_of

        stage_of = None
        # provenance for pricing: pins execute one stage per device
        # (v=1); the auto-cut path interleaves v stages per device.
        # _price_1f1b_ticks and staged_pipeline_cost must see the SAME
        # layout compile runs, not re-guess it from axis sizes.
        self._staged_vstages = 1
        try:
            stage_of = viable(assignment_from_pins(self.model, strategy))
        except (ValueError, NotImplementedError):
            stage_of = None  # compile warns and falls through, as here
        if stage_of is None \
                and getattr(self.model.config, "pipeline_stages", 0) > 1:
            # strategy-independent: the O(S*n^2) partition DP and plan
            # viability check run once, not per annealing candidate.
            # Mirror compile: auto-cut produces pipeline_stages * v
            # stages laid round-robin over pipeline_stages devices
            v = max(1, getattr(self.model.config,
                               "pipeline_virtual_stages", 1))
            S_req = self.model.config.pipeline_stages * v
            cache = self._balanced_cache
            # keyed by (S, v): the same stage count can be viable under
            # one interleaving factor and not another (the pipe axis
            # carries S/v devices), and the search sweeps v
            if (S_req, v) not in cache:
                cache[(S_req, v)] = viable(
                    balanced_stages(self.model, S_req), vstages=v)
            stage_of = cache[(S_req, v)]
            if stage_of is not None:
                self._staged_vstages = v
        return stage_of

    def _simulate_staged(self, strategy: Strategy, stage_of,
                         dot_path: Optional[str] = None,
                         record: bool = False):
        """Event-loop makespan of a graph-level staged strategy: one
        pipeline covering the whole model, per-stage tick costs from the
        cost model (staged_pipeline_cost), per-stage grad sync, memory
        from the schedule's activation peak."""
        from .cost_model import staged_pipeline_cost
        cfg = self.model.config
        vstages = max(1, getattr(self, "_staged_vstages", 1))
        n_stages = max(stage_of.values()) + 1
        key = (tuple(sorted(stage_of.items())),
               getattr(cfg, "pipeline_microbatches", 4),
               getattr(cfg, "pipeline_schedule", "gpipe"),
               vstages)
        cache = self._staged_cost_cache
        if key in cache:  # the annealing loop revisits candidates
            pc, syncs, mem = cache[key]
        else:
            pc, syncs, mem = cache[key] = staged_pipeline_cost(
                self.model, self.mesh, self.mm, stage_of, key[1],
                schedule=key[2],
                n_dev=(n_stages // vstages
                       if n_stages % vstages == 0 else None))
        tick_step = (self._price_1f1b_ticks(pc, syncs)
                     if key[2] == "1f1b" else None)
        if tick_step is not None and not dot_path and not record:
            return tick_step, self.mm.memory_penalty(mem)
        g = TaskGraph()
        exits: Dict[str, List] = {}
        fwd_join = self._expand_pipeline_fwd(g, "net", pc, [], exits)
        bwd_join = self._expand_pipeline_bwd(g, "net", pc, [fwd_join],
                                             exits["net"])
        for k, s in enumerate(syncs):
            if s > 0:
                g.add(f"net:sync.s{k}", s, "comm", [bwd_join])
        step_time = g.simulate(record)
        if record:
            self._last_graph = g
        if dot_path:
            g.export_dot(dot_path)
        if tick_step is not None:  # DOT exported; price stays tick-based
            step_time = tick_step
        return step_time, self.mm.memory_penalty(mem)

    def _price_1f1b_ticks(self, pc, syncs):
        """Price a 1F1B (incl. interleaved v > 1) staged strategy from
        the ACTUAL schedule tables the executor runs
        (parallel/graph_pipeline.interleaved_schedule). The executed
        program is a tick-lockstep lax.scan — every device runs one
        switch branch per tick, then both wire ppermutes — so tick t
        costs max over devices of the unit worked that tick, plus the
        two uniform-width wire hops; the bubble falls out of the IDLE
        entries. Returns None when the stage count does not divide the
        pipe axis (the executor would have rejected it too)."""
        import numpy as np
        S, M = pc.stages, pc.microbatches
        # _staged_assignment recorded which lowering produced this
        # stage_of (pins: one stage per device; auto-cut: v stages per
        # device) — price exactly that layout, never re-guess from axis
        # sizes (a same-size unrelated axis must not flip the schedule)
        v = max(1, getattr(self, "_staged_vstages", 1))
        if S % v != 0:
            return None
        n_dev = S // v
        kind, _mbi, sidx, _depth = _schedule_tables(n_dev, v, M)
        fwd = np.asarray([pc.fwd_at(k) for k in range(S)])
        bwd = np.asarray([pc.bwd_at(k) for k in range(S)])
        from ..parallel.graph_pipeline import BWD, FWD
        sidx_c = np.clip(sidx, 0, S - 1)
        cost = np.where(kind == FWD, fwd[sidx_c],
                        np.where(kind == BWD, bwd[sidx_c], 0.0))
        # two wires (activations +1 ring, cotangents -1 ring) ppermute
        # every tick at the max cut width (the wire pads to it)
        hop = 2.0 * (max(pc.hops) if pc.hops else pc.hop)
        ticks = float(cost.max(axis=1).sum()) + kind.shape[0] * hop
        return ticks + sum(syncs)

    def _simulate_raw(self, strategy: Strategy,
                      dot_path: Optional[str] = None,
                      record: bool = False):
        """Returns (unscaled step seconds, memory penalty seconds)."""
        stage_of = self._staged_assignment(strategy)
        if stage_of is not None:
            return self._simulate_staged(strategy, stage_of, dot_path,
                                         record)
        built = self._build_graph(strategy)
        step_time = built.graph.simulate(record)
        if record:
            self._last_graph = built.graph
        if dot_path:
            built.graph.export_dot(dot_path)
        return step_time, self.mm.memory_penalty(built.total_mem)

    def export_schedule(self, strategy: Strategy, path: str) -> dict:
        """Export the simulated event-loop schedule of `strategy` as a
        Perfetto-loadable Chrome trace (rendered through
        utils/telemetry.Telemetry.export_chrome_trace): one track per
        simulated resource (compute stream, ICI fabric, per-device /
        per-stage rows), each task a complete span carrying its exact
        start/end seconds and critical-path flag in ``args``, plus
        anchor spans for the calibrated dispatch overhead and the HBM
        penalty so the trace's exact end time
        (``metadata["makespan_s"]``, = the max ``t_end_s`` over events)
        equals :meth:`simulate`'s return for the same strategy
        bit-exactly. Returns a summary dict (path, makespan_s, task and
        critical-path counts)."""
        from ..utils.telemetry import Telemetry
        self._last_graph = None
        step_raw, penalty = self._simulate_raw(strategy, record=True)
        g = self._last_graph
        # the SAME float expression simulate() evaluates — bit-equality
        # of the trace end with the priced step time is the contract
        total = step_raw * self.time_scale + penalty + self.step_overhead
        crit = g.critical_path()
        scale = self.time_scale
        off = self.step_overhead
        # a tick-priced 1F1B staged strategy returns the tick-table
        # price while the recorded graph is the event-loop VISUAL —
        # normalize the graph onto the priced span (factor is exactly
        # 1.0 whenever the event loop IS the price, i.e. every
        # non-staged and gpipe-staged strategy) and clamp to the
        # anchor so the trace end stays bit-equal to simulate()
        graph_end = max((t.finish_time for t in g.tasks), default=0.0)
        eff = scale if graph_end == step_raw or graph_end <= 0.0 \
            else scale * (step_raw / graph_end)
        pen_start = off + step_raw * scale
        events = [t for t in g.tasks if t.duration > 0.0]
        # t0=0.0 pins the trace clock: spans carry trace-absolute
        # simulator seconds, not wall time
        tel = Telemetry(enabled=True, max_events=len(events) + 8,
                        t0=0.0)
        if off > 0.0:
            tel.span(("sim", "host"), "step_overhead", 0.0, off,
                     args={"t_start_s": 0.0, "t_end_s": off,
                           "crit": False})
        n_crit = 0
        for t in events:
            t0 = min(off + t.start_time * eff, pen_start)
            t1 = min(off + t.finish_time * eff, pen_start)
            on_crit = id(t) in crit
            n_crit += bool(on_crit)
            tel.span(_res_track(t.resource), t.name, t0, t1,
                     args={"t_start_s": t0, "t_end_s": t1,
                           "crit": bool(on_crit),
                           "res": _res_label(t.resource)})
        # tail anchor: the (strategy-dependent) HBM penalty closes the
        # trace at the exact priced step time, zero-width when no
        # penalty applies
        tel.span(("sim", "hbm"), "hbm_penalty", pen_start, total,
                 args={"t_start_s": pen_start, "t_end_s": total,
                       "crit": False, "penalty_s": penalty})
        summary = {
            "path": path, "makespan_s": total,
            "event_loop_s": step_raw, "time_scale": scale,
            "hbm_penalty_s": penalty, "step_overhead_s": off,
            "tasks": len(events), "critical_tasks": n_crit,
            "domain": "train",
        }
        tel.export_chrome_trace(path, metadata=dict(summary))
        return summary

    # task classes of the drift attribution (docs/observability.md):
    # the train half — compute fwd/bwd, the optimizer-update sweep,
    # fwd/bwd collectives, and the DP grad sync (bucketed or per-op)
    TRAIN_TASK_CLASSES = ("fwd", "bwd", "update", "collective",
                          "grad_sync", "overhead")

    def step_breakdown(self, strategy: Strategy) -> Dict[str, float]:
        """Predicted seconds per task CLASS for one step of `strategy`
        — the attribution vector the drift calibrator aligns measured
        steps against (utils/telemetry.record_drift(breakdown=...)).
        These are summed task durations (scaled like simulate()), not
        makespan shares: overlapped classes intentionally sum past the
        critical path, which is exactly what lets the least-squares
        attribution tell WHICH term mis-prices."""
        out = {k: 0.0 for k in self.TRAIN_TASK_CLASSES}
        for op in self.model.ops:
            c = self._op_cost(op, strategy)
            out["fwd"] += c.fwd
            out["bwd"] += c.bwd
            out["update"] += c.update
            out["collective"] += c.fwd_comm + c.bwd_comm
            out["grad_sync"] += c.sync
        s = self.time_scale
        out = {k: v * s for k, v in out.items()}
        out["overhead"] = self.step_overhead
        return out

    def _build_graph(self, strategy: Strategy) -> "_BuiltGraph":
        """Build the (non-staged) task graph for `strategy`. Comm and
        grad-sync tasks are ALWAYS materialized, zero-duration when the
        cost is zero — numerically identical to skipping them (the
        zero-duration pass-through in TaskGraph.simulate), but it keeps
        the task-graph STRUCTURE independent of the axis maps, which is
        what lets simulate_delta reuse one scheduled template across
        rewrite/propagate moves and only re-cost the changed ops."""
        g = TaskGraph()
        fwd_tasks: Dict[str, SimTask] = {}

        total_mem = 0.0
        costs = {op.name: self._op_cost(op, strategy)
                 for op in self.model.ops}

        # fusion (reference FusedOp simulated as ONE task per group,
        # fused.cu fwd/bwd dispatch): each unit is a singleton op or a
        # same-strategy chain costed as one task; member costs (incl.
        # intrinsic collectives like TP all-reduces) are summed.
        groups, unit_deps, unit_consumers = self._units_for(strategy)
        unit_cost: Dict[str, OpCost] = {}
        for grp in groups:
            c = costs[grp[0]]
            for m in grp[1:]:
                c = c.merge(costs[m])
            unit_cost[grp[-1]] = c
        unit_order = [g_[-1] for g_ in groups]

        # compute-resource assignment: mesh-uniform SPMD units share one
        # "compute" stream; a device-placed unit (OpStrategy.device_ids)
        # occupies only its own devices, so disjoint placements run
        # concurrently (reference: ops with disjoint ParallelConfig
        # device_ids proceed in parallel under Legion's dataflow).
        singleton = {grp[-1] for grp in groups if len(grp) == 1}
        placed = {u: strategy.for_op(u).device_ids for u in unit_order
                  if u in singleton and strategy.for_op(u).device_ids}
        all_devs = [("dev", i) for i in range(int(self.mesh.size))] \
            if placed else []

        def res_for(u):
            if u in placed:
                return [("dev", int(i)) for i in placed[u]]
            return ["compute"] + all_devs if placed else "compute"

        # pipeline units (singleton pipeline_blocks with layer->pipe):
        # expanded into the real (microbatch, stage) GPipe schedule over
        # per-stage resources instead of one closed-form task (the event
        # loop the reference runs for every task, simulator.cc:330-629).
        expanded = {u for u in unit_order
                    if unit_cost[u].pipeline is not None and u in singleton}
        pipe_fwd_exit: Dict[str, List[List[SimTask]]] = {}
        slots: Dict[str, Dict[str, SimTask]] = {}

        # forward chain
        for u in unit_order:
            c = unit_cost[u]
            deps = [fwd_tasks[pu] for pu in unit_deps[u] if pu in fwd_tasks]
            if u in expanded:
                fwd_tasks[u] = self._expand_pipeline_fwd(
                    g, u, c.pipeline, deps, pipe_fwd_exit)
                total_mem += c.mem
                continue
            comm = g.add(f"{u}:fwd_comm", c.fwd_comm, "comm", deps)
            deps = deps + [comm]
            fwd_tasks[u] = g.add(f"{u}:fwd", c.fwd, res_for(u), deps)
            slots[u] = {"fwd_comm": comm, "fwd": fwd_tasks[u]}
            total_mem += c.mem

        # bucketed grad sync (FFConfig.grad_bucket_mb, core/overlap.py):
        # when the runtime buckets, the simulator prices the SAME
        # partition — per-op sync tasks go zero-duration (keeping the
        # 5-slot structure the delta template splices into) and one
        # bucket task per bucket carries the combined all-reduce of its
        # members' payloads, depending on the members' backward tasks.
        # The partition walks UNITS (singleton ops when fusion is off —
        # then it equals core/overlap.grad_buckets exactly, the
        # executor's partition) accumulating the dense master bytes of
        # each unit's member ops; sparse-update tables stay outside
        # (their row grads scatter, keeping their own sync task), as do
        # pipeline-expanded and device-placed units. A serialized
        # (--no-overlap-sync) search keeps the legacy per-op syncs.
        bucket_members: List[List[str]] = []
        bucket_set: set = set()
        if self.overlap and self.bucket_mb > 0:
            from ..core.overlap import eligible_sparse_ops
            sparse = eligible_sparse_ops(self.model)
            members_of = {grp[-1]: grp for grp in groups}
            limit = float(self.bucket_mb) * (1 << 20)
            cur: List[str] = []
            cur_bytes = 0.0
            for u in unit_order:
                if u in expanded or u in placed:
                    continue
                w = sum(float(self._ops_by_name[m].weight_bytes())
                        for m in members_of[u]
                        if m not in sparse
                        and self._ops_by_name[m].weight_specs())
                if w <= 0:
                    continue
                cur.append(u)
                cur_bytes += w
                if cur_bytes >= limit:
                    bucket_members.append(cur)
                    cur, cur_bytes = [], 0.0
            if cur:
                bucket_members.append(cur)
            bucket_set = {n for m in bucket_members for n in m}

        # backward chain (reverse graph)
        bwd_tasks: Dict[str, SimTask] = {}
        sync_tasks: List[SimTask] = []
        for u in reversed(unit_order):
            c = unit_cost[u]
            deps = [bwd_tasks[cons] for cons in unit_consumers.get(u, [])
                    if cons in bwd_tasks]
            if not deps:
                deps = [fwd_tasks[unit_order[-1]]]
            if u in expanded:
                bwd_tasks[u] = self._expand_pipeline_bwd(
                    g, u, c.pipeline, deps, pipe_fwd_exit[u])
            else:
                comm = g.add(f"{u}:bwd_comm", c.bwd_comm, "comm", deps)
                deps = deps + [comm]
                bwd_tasks[u] = g.add(f"{u}:bwd", c.bwd + c.update,
                                     res_for(u), deps)
                slots[u]["bwd_comm"] = comm
                slots[u]["bwd"] = bwd_tasks[u]
            # grad all-reduce may overlap the rest of backward
            # (reference overlap flag, simulator.cc:393-497); bucketed
            # members sync through their bucket task instead
            st = g.add(f"{u}:grad_sync",
                       0.0 if u in bucket_set else c.sync,
                       "comm", [bwd_tasks[u]])
            sync_tasks.append(st)
            if u in slots:
                slots[u]["sync"] = st

        bucket_tasks: List[SimTask] = []
        for k, members in enumerate(bucket_members):
            payload = 0.0
            for m in members:   # walk order — the delta path re-sums
                # UNIT cost, not costs[m]: the zeroed per-unit sync
                # task covered the whole fused group's payload, so the
                # bucket must carry the merged sum (identical to the
                # per-op cost when fusion is off — the delta path,
                # fusion-disabled, re-sums the same values bit-equally)
                payload += unit_cost[m].sync_bytes
            bucket_tasks.append(g.add(
                f"grad_bucket_sync.{k}", self._bucket_sync_cost(payload),
                "comm", [bwd_tasks[m] for m in members]))

        if not self.overlap and sync_tasks:
            # serialize syncs after all backward work: model by chaining
            last_bwd = bwd_tasks[unit_order[0]]
            for st in sync_tasks:
                st.deps.append(last_bwd)

        return _BuiltGraph(graph=g, total_mem=total_mem, costs=costs,
                           slots=slots, expanded=expanded, placed=placed,
                           bucket_members=bucket_members,
                           bucket_tasks=bucket_tasks)

    def _bucket_sync_cost(self, payload_bytes: float) -> float:
        """One bucket's combined DP all-reduce: the summed per-device
        payload over the mesh's data axis — one latency term per
        BUCKET, which is exactly what bucketing buys over per-op
        syncs."""
        dp = int(self.mesh.shape.get("data", 1))
        if dp <= 1 or payload_bytes <= 0:
            return 0.0
        return self.mm.all_reduce(
            payload_bytes, dp, "data" if "data" in self.mesh.shape
            else None)

    # ---------------- delta simulation ----------------
    def delta_rebase(self, strategy: Strategy) -> bool:
        """(Re)build the delta template from `strategy` — the scheduled
        task graph subsequent simulate_delta calls splice into. Returns
        False (template cleared) when the delta path cannot represent
        this strategy: fused searches (unit partition moves with the
        axis maps), staged/pinned pipelines, or device-placed ops
        (per-device resource lists change with the assignment)."""
        self._delta = None
        cfg = getattr(self.model, "config", None)
        if not getattr(cfg, "search_delta_sim", True):
            return False
        if getattr(cfg, "perform_fusion", False):
            return False
        # cheap pre-checks before paying for a graph build: placed ops
        # get per-device resource lists (structure tracks the
        # assignment), and _anneal_chain re-rebases after every
        # accepted structural move — a placed-heavy walk would
        # otherwise pay a wasted full build per accepted move
        if any(strategy.for_op(op.name).device_ids
               for op in self.model.ops):
            return False
        if self._staged_assignment(strategy) is not None:
            return False
        built = self._build_graph(strategy)
        if built.placed:  # unreachable given the pre-check; defensive
            return False
        tasks = built.graph.tasks
        index = {id(task): i for i, task in enumerate(tasks)}
        n = len(tasks)
        t = _DeltaTemplate()
        t.durations = [task.duration for task in tasks]
        t.ndeps0 = [len(task.deps) for task in tasks]
        children: List[List[int]] = [[] for _ in range(n)]
        for i, task in enumerate(tasks):
            for d in task.deps:
                children[index[id(d)]].append(i)
        t.children = [tuple(c) for c in children]
        t.roots = tuple(i for i, task in enumerate(tasks)
                        if not task.deps)
        res_ids: Dict[object, int] = {}
        res = []
        for task in tasks:
            key = (tuple(task.resource)
                   if isinstance(task.resource, list) else task.resource)
            if key not in res_ids:
                res_ids[key] = len(res_ids)
            res.append(res_ids[key])
        t.res = res
        t.n_res = len(res_ids)
        t.op_slots = {u: tuple(index[id(d[sn])] for sn in _SLOT_NAMES)
                      for u, d in built.slots.items()}
        t.op_sig = {op.name: _axis_sig(strategy.for_op(op.name))
                    for op in self.model.ops}
        t.op_class = {name: built.costs[name].pipeline is not None
                      for name in t.op_sig}
        t.op_mem = {name: built.costs[name].mem for name in t.op_sig}
        t.op_order = tuple(op.name for op in self.model.ops)
        # bucketed grad sync: per-op payloads + bucket membership so a
        # moved op's bucket re-prices from the SAME member sum the full
        # build uses (bit-equal), spliced into the bucket task's slot
        t.op_sync_bytes = {name: built.costs[name].sync_bytes
                           for name in t.op_sig}
        t.bucket_members = [tuple(m) for m in built.bucket_members]
        t.bucket_of = {name: k for k, m in enumerate(t.bucket_members)
                       for name in m}
        t.bucket_slot = [index[id(task)] for task in built.bucket_tasks]
        self._delta = t
        return True

    def simulate_delta(self, strategy: Strategy,
                       changed_ops) -> Optional[_DeltaToken]:
        """Delta re-simulation of `strategy`, which must differ from the
        template's base only in `changed_ops`: re-cost just those ops
        (cache-served for revisited candidates), splice the durations
        into the cached scheduled graph, and replay the event loop over
        the flat arrays. Returns None when the move changes task-graph
        STRUCTURE (op enters/leaves pipeline expansion or device
        placement) — the caller falls back to a full simulate() and
        delta_rebase(). The returned token's mutations are already
        applied; call delta_reject(token) to roll them back when the
        move is rejected (accepting needs no call)."""
        t = self._delta
        if t is None:
            return None
        updates = []
        for name in changed_ops:
            op = self._ops_by_name.get(name)
            if op is None:
                continue
            s = strategy.for_op(name)
            sig = _axis_sig(s)
            if sig == t.op_sig.get(name):
                continue  # no-op move (picked the current candidate)
            if name not in t.op_slots or s.device_ids:
                # pipeline-expanded unit or a device-placement rewrite:
                # the template's task structure no longer matches
                self.stats["delta_fallbacks"] += 1
                return None
            c = self._op_cost_for(op, s, sig)
            if (c.pipeline is not None) != t.op_class[name]:
                self.stats["delta_fallbacks"] += 1
                return None
            updates.append((name, sig, c))
        undo = []
        d = t.durations
        touched_buckets = set()
        for name, sig, c in updates:
            i_fc, i_f, i_bc, i_b, i_s = t.op_slots[name]
            undo.append((name, t.op_sig[name], t.op_mem[name],
                         t.op_sync_bytes[name],
                         (d[i_fc], d[i_f], d[i_bc], d[i_b], d[i_s])))
            d[i_fc] = c.fwd_comm
            d[i_f] = c.fwd
            d[i_bc] = c.bwd_comm
            d[i_b] = c.bwd + c.update
            b = t.bucket_of.get(name)
            # bucketed members keep their zero per-op sync slot; their
            # bucket's task re-prices below from the new payloads
            d[i_s] = 0.0 if b is not None else c.sync
            if b is not None:
                touched_buckets.add(b)
            t.op_sig[name] = sig
            t.op_mem[name] = c.mem
            t.op_sync_bytes[name] = c.sync_bytes
        bucket_undo = []
        for b in sorted(touched_buckets):
            i_bk = t.bucket_slot[b]
            bucket_undo.append((i_bk, d[i_bk]))
            payload = 0.0
            for m in t.bucket_members[b]:   # same walk-order sum as
                payload += t.op_sync_bytes[m]  # _build_graph: bit-equal
            d[i_bk] = self._bucket_sync_cost(payload)
        makespan = self._replay(t)
        total_mem = 0.0
        om = t.op_mem
        for name in t.op_order:  # same accumulation order as
            total_mem += om[name]  # _build_graph -> bit-equal penalty
        self.stats["delta_sims"] += 1
        return _DeltaToken(
            cost=(makespan * self.time_scale
                  + self.mm.memory_penalty(total_mem)
                  + self.step_overhead),
            undo=(undo, bucket_undo))

    def delta_reject(self, tok: _DeltaToken) -> None:
        """Roll the template back to its pre-simulate_delta state."""
        t = self._delta
        if t is None:
            return
        d = t.durations
        ops_undo, bucket_undo = tok.undo
        for name, sig, mem, sync_bytes, durs in ops_undo:
            i_fc, i_f, i_bc, i_b, i_s = t.op_slots[name]
            d[i_fc], d[i_f], d[i_bc], d[i_b], d[i_s] = durs
            t.op_sig[name] = sig
            t.op_mem[name] = mem
            t.op_sync_bytes[name] = sync_bytes
        for i_bk, dur in bucket_undo:
            d[i_bk] = dur

    def _replay(self, t: _DeltaTemplate) -> float:
        """Array-form of TaskGraph.simulate over the cached template:
        identical pop order (ready-time heap, creation-order counter
        tie-break) and identical zero-duration transparency, so the
        returned makespan is bit-equal to a full rebuild-and-simulate
        of the same strategy — without allocating a single SimTask."""
        heappush = heapq.heappush
        heappop = heapq.heappop
        durations = t.durations
        children = t.children
        res = t.res
        ndeps = t.ndeps0[:]
        ready = [0.0] * len(durations)
        free = [0.0] * t.n_res
        q = [(0.0, i, idx) for i, idx in enumerate(t.roots)]
        counter = len(q)
        makespan = 0.0
        while q:
            r, _, i = heappop(q)
            dur = durations[i]
            if dur == 0.0:
                f = r
            else:
                k = res[i]
                fr = free[k]
                f = (fr if fr > r else r) + dur
                free[k] = f
                if f > makespan:
                    makespan = f
            for ch in children[i]:
                if f > ready[ch]:
                    ready[ch] = f
                ndeps[ch] -= 1
                if ndeps[ch] == 0:
                    heappush(q, (ready[ch], counter, ch))
                    counter += 1
        return makespan

    def _expand_pipeline_fwd(self, g, u, pc, ext_deps, pipe_fwd_exit):
        """Emit the GPipe forward: microbatch m flows stage 0..S-1, one
        hop between stages; stage k is its own resource, so the bubble
        emerges from the event loop rather than a closed form. Returns a
        zero-duration join task (= the unit's fwd handle)."""
        S, M = pc.stages, pc.microbatches
        rows: List[List[SimTask]] = []
        for m in range(M):
            row = []
            prev = None
            for k in range(S):
                deps = list(ext_deps) if k == 0 else []
                if prev is not None:
                    hop = pc.hop_at(k)
                    if hop > 0:
                        h = g.add(f"{u}:f{m}.hop{k}", hop, "comm",
                                  [prev])
                        deps.append(h)
                    else:
                        deps.append(prev)
                prev = g.add(f"{u}:f{m}.s{k}", pc.fwd_at(k),
                             ("stage", u, k), deps)
                row.append(prev)
            rows.append(row)
        pipe_fwd_exit[u] = rows
        join = g.add(f"{u}:fwd_join", 0.0, ("join", u, "f"),
                     [r[-1] for r in rows])
        return join

    def _expand_pipeline_bwd(self, g, u, pc, ext_deps, fwd_rows):
        """GPipe backward: microbatch m flows stage S-1..0 (each bwd tick
        also depends on that microbatch's forward at the same stage —
        stashed activations)."""
        S, M = pc.stages, pc.microbatches
        exits = []
        for m in range(M):
            prev = None
            for k in reversed(range(S)):
                deps = list(ext_deps) if k == S - 1 else []
                deps.append(fwd_rows[m][k])
                if prev is not None:
                    hop = pc.hop_at(k + 1)
                    if hop > 0:
                        h = g.add(f"{u}:b{m}.hop{k}", hop, "comm",
                                  [prev])
                        deps.append(h)
                    else:
                        deps.append(prev)
                prev = g.add(f"{u}:b{m}.s{k}", pc.bwd_at(k),
                             ("stage", u, k), deps)
            exits.append(prev)
        return g.add(f"{u}:bwd_join", 0.0, ("join", u, "b"), exits)

    def memory_per_device(self, strategy: Strategy) -> float:
        return sum(self._op_cost(op, strategy).mem for op in self.model.ops)


# ---------------------------------------------------------------------------
# Serve-step simulation
# ---------------------------------------------------------------------------

def serve_task_schedule(tasks) -> Dict[str, tuple]:
    """(start, finish) seconds per task of a serve-step task graph
    (cost_model.serve_step_tasks): finish(t) = duration(t) +
    max(finish(deps)). The ONE chain evaluation — the makespan
    (simulate_serve_tasks) and the schedule export derive from this
    same float accumulation, which is what keeps the exported trace's
    end time bit-equal to the simulated step."""
    sched: Dict[str, tuple] = {}
    for t in tasks:  # serve_step_tasks emits in dependency order
        start = max((sched[d][1] for d in t.deps if d in sched),
                    default=0.0)
        sched[t.name] = (start, start + t.seconds)
    return sched


def simulate_serve_tasks(tasks) -> float:
    """Makespan of a serve-step task graph (cost_model.serve_step_tasks)
    — the critical path over named dependencies. Tensor-parallel
    serving's collectives sit ON the critical path (each all-reduce
    feeds the very next matmul — there is no second microbatch to hide
    them behind, unlike training's bucketed grad sync), so the chain
    evaluation IS the event loop (serve_task_schedule). Kept
    structural (not a plain sum) so a future serve graph with parallel
    branches (e.g. draft-LM lanes priced beside the target) simulates
    unchanged."""
    return max((f for _, f in serve_task_schedule(tasks).values()),
               default=0.0)


def simulate_serve_step(arch, tensor_parallel: int,
                        mm: Optional[H100MachineModel] = None, *,
                        lanes: Optional[int] = None,
                        axis_dims: tuple = (),
                        transfer_tokens: int = 0) -> float:
    """Simulated seconds of ONE mixed serving step with `lanes` query
    lanes (default: a full decode step — `arch.decode_lanes`) at the
    given tensor-parallel degree, including the reference-style
    1ms/MB penalty when the per-device resident bytes exceed HBM
    (simulator.cc:603-628 — what makes a too-big-for-one-chip model
    price its own sharding). `axis_dims` pins the serve axis onto
    physical torus dims (machine_model._phys) — the axis-assignment
    half of the placement search. `transfer_tokens` > 0 prices a
    disaggregated page handoff of that many tokens riding the host
    link BESIDE the step (cost_model.serve_step_tasks): the makespan
    grows only when the link is the bottleneck — the decode-engine
    import-while-decoding steady state."""
    from .cost_model import (SERVE_AXIS, serve_device_bytes,
                             serve_step_tasks)
    if mm is None:
        mm = _machine.default_machine_model()
    if axis_dims:
        mm = dataclasses.replace(
            mm, axis_topology={**mm.axis_topology,
                               SERVE_AXIS: tuple(axis_dims)})
    step = simulate_serve_tasks(serve_step_tasks(
        arch, tensor_parallel, mm,
        lanes=int(arch.decode_lanes if lanes is None else lanes),
        transfer_tokens=int(transfer_tokens)))
    return step + mm.memory_penalty(
        serve_device_bytes(arch, tensor_parallel))


# task classes of the serve drift attribution: the paged-attention
# kernel, the dense matmuls (qkv/wo/ffn/head/embed), the tensor-
# parallel collectives (all-reduces + the logits all-gather), and the
# disaggregated page-handoff host-link transfer
SERVE_TASK_CLASSES = ("attention", "matmul", "collective", "transfer")


def serve_task_class(task) -> str:
    """Attribution class of one ServeTask (cost_model.serve_step_tasks
    names are stable: ``l{i}.attn`` is the paged-attention kernel)."""
    if task.kind == "collective":
        return "collective"
    if task.kind == "transfer":
        return "transfer"
    if task.name.endswith(".attn"):
        return "attention"
    return "matmul"


def serve_step_breakdown(arch, tensor_parallel: int,
                         mm: Optional[H100MachineModel] = None, *,
                         lanes: Optional[int] = None,
                         axis_dims: tuple = (),
                         transfer_tokens: int = 0) -> Dict[str, float]:
    """Predicted seconds per task class of ONE mixed serving step —
    the serve half of the drift attribution vector. The serve compute
    graph is a serial chain, so with no transfer task the classes
    (plus the HBM penalty) sum exactly to
    :func:`simulate_serve_step`; a priced handoff runs BESIDE the
    chain, so its class reports its own seconds while the makespan
    stays max(chain, transfer)."""
    from .cost_model import SERVE_AXIS, serve_device_bytes, \
        serve_step_tasks
    if mm is None:
        mm = _machine.default_machine_model()
    if axis_dims:
        mm = dataclasses.replace(
            mm, axis_topology={**mm.axis_topology,
                               SERVE_AXIS: tuple(axis_dims)})
    out = {k: 0.0 for k in SERVE_TASK_CLASSES}
    for t in serve_step_tasks(
            arch, tensor_parallel, mm,
            lanes=int(arch.decode_lanes if lanes is None else lanes),
            transfer_tokens=int(transfer_tokens)):
        out[serve_task_class(t)] += t.seconds
    out["hbm_penalty"] = mm.memory_penalty(
        serve_device_bytes(arch, tensor_parallel))
    return out


def export_serve_schedule(arch, tensor_parallel: int, path: str,
                          mm: Optional[H100MachineModel] = None, *,
                          lanes: Optional[int] = None,
                          axis_dims: tuple = (),
                          transfer_tokens: int = 0) -> dict:
    """Perfetto-loadable export of the simulated serve-step schedule
    (the serving mirror of Simulator.export_schedule): one track per
    task class, every task a complete span with exact start/end seconds
    in ``args``, an ``hbm_penalty`` anchor closing the trace at exactly
    :func:`simulate_serve_step`'s return for the same placement
    (``metadata["makespan_s"]``). The serve chain is serial, so every
    task is on the critical path by construction."""
    from ..utils.telemetry import Telemetry
    from .cost_model import SERVE_AXIS, serve_device_bytes, \
        serve_step_tasks
    if mm is None:
        mm = _machine.default_machine_model()
    if axis_dims:
        mm = dataclasses.replace(
            mm, axis_topology={**mm.axis_topology,
                               SERVE_AXIS: tuple(axis_dims)})
    tasks = serve_step_tasks(
        arch, tensor_parallel, mm,
        lanes=int(arch.decode_lanes if lanes is None else lanes),
        transfer_tokens=int(transfer_tokens))
    penalty = mm.memory_penalty(
        serve_device_bytes(arch, tensor_parallel))
    # the SAME chain evaluation simulate_serve_tasks prices from
    sched = serve_task_schedule(tasks)
    tel = Telemetry(enabled=True, max_events=len(tasks) + 8, t0=0.0)
    end = 0.0
    for t in tasks:
        start, finish = sched[t.name]
        end = max(end, finish)
        if t.seconds > 0.0:
            tel.span(("sim", serve_task_class(t)), t.name, start,
                     finish,
                     args={"t_start_s": start,
                           "t_end_s": finish, "crit": True,
                           "kind": t.kind})
    total = end + penalty  # simulate_serve_step's float expression
    tel.span(("sim", "hbm"), "hbm_penalty", end, total,
             args={"t_start_s": end, "t_end_s": total, "crit": False,
                   "penalty_s": penalty})
    summary = {
        "path": path, "makespan_s": total, "event_loop_s": end,
        "hbm_penalty_s": penalty, "tasks": len(tasks),
        "tensor_parallel": int(tensor_parallel), "domain": "serve",
    }
    tel.export_chrome_trace(path, metadata=dict(summary))
    return summary
