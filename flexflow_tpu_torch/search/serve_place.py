"""Inference-placement search (``flexflow_tpu/search/serve_place.py``,
whole): the paper's simulator-driven search applied to serving.

``optimize_serve`` walks (tensor-parallel degree, physical axis
assignment) pairs for the ONE mixed prefill+decode step, priced by the
serve task graph (cost_model.serve_step_tasks) through the serve event
loop (simulator.simulate_serve_step), with the Metropolis acceptance of
the training search; it is what ``serve_mesh="auto"`` resolves through.
``optimize_serve_mesh`` searches the 2-D (tensor x data) pool space a
``serve_replicas="auto"`` ReplicaPool boots from, under a goodput-under-
SLO objective, HBM-infeasible degrees rejected up front.
``optimize_serve_disagg`` prices the prefill:decode split with the page
handoff on the host link and returns the ratio table
(``serve_disagg_ratio="auto"``).

It is pure pricing, the JAX package's code on the port's machine model:
on the same machine numbers and seed both packages pick the same
placement. Step prices persist in the shared CostCache under a
fingerprint folding the serve signature, so a placement or KV-dtype
flip is a guaranteed miss. A searched degree above 1 runs as a
tensor-parallel engine on that many ranks of the process group
(serve/engine.py).
"""

from __future__ import annotations

import dataclasses
import math
import random
import warnings
from typing import Dict, List, Optional, Tuple

from . import machine_model as _machine
from .cost_model import ServeArch, kv_handoff_bytes, serve_device_bytes
from .machine_model import H100MachineModel
from .simulator import simulate_serve_step

# objective weights: serving steady state is decode-dominated (every
# request decodes for its whole output length but prefills once), so
# the decode step carries the objective and the prefill chunk enters
# at a fraction — enough that a placement which wrecks prefill cannot
# win on decode alone.
PREFILL_WEIGHT = 0.25


@dataclasses.dataclass(frozen=True)
class ServePlacement:
    """One serve placement the search priced (the winner when returned
    by optimize_serve): the tensor-parallel degree the engine shards
    the mixed program to, the physical torus dims the serve axis rides
    (() = one flat ICI ring), and the simulated steady-state costs."""
    tensor_parallel: int
    axis_dims: Tuple[int, ...]
    decode_step_s: float
    prefill_step_s: float
    cost: float
    # every candidate degree's best decode step (axis optimized away) —
    # (the t-sweep a report renders)
    decode_by_degree: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    fingerprint: str = ""
    # convergence diagnostics of the placement walk
    # (search/trace.SearchTrace.summary(); None with tracing off)
    trace: Optional[dict] = None

    def speedup_vs_single(self) -> float:
        base = self.decode_by_degree.get(1)
        if base is None:
            # a partial-budget search (or a head count not divisible
            # by 1 — impossible, but a fixed-degree table) can return
            # a table without the t=1 baseline; the ratio degrades to
            # 1.0 so report renderers keep working
            warnings.warn(
                "serve decode table has no t=1 baseline; reporting "
                "speedup_vs_single as 1.0x",
                RuntimeWarning, stacklevel=2)
            return 1.0
        if not base or not self.decode_step_s:
            return 1.0
        return base / self.decode_step_s


def candidate_degrees(arch: ServeArch, num_devices: int) -> List[int]:
    """Tensor degrees the engine can actually run: divisors of the
    head count, bounded by the device count (head sharding is the
    backbone — ff/vocab pad, heads cannot)."""
    n = max(1, int(num_devices))
    return [t for t in range(1, n + 1)
            if arch.num_heads % t == 0]


def axis_assignments(mm: H100MachineModel, t: int) -> List[Tuple[int, ...]]:
    """Physical layouts the serve axis could take on this machine: the
    flat single ring always, plus every contiguous run of the spec's
    ICI torus dims whose product is exactly t (a k-dim assignment runs
    ring phases over k link sets concurrently — machine_model._phys).
    Deduplicated: on a square/cubic torus symmetric runs produce the
    SAME dims tuple (e.g. (4, 4) yields (4,) twice at t=4) and the
    cost model prices dims, not positions — duplicates would only
    burn walk proposals on candidates already visited."""
    out: List[Tuple[int, ...]] = [()]
    seen = {()}
    dims = tuple(getattr(mm.spec, "ici_torus_dims", ()) or ())
    for i in range(len(dims)):
        prod = 1
        for j in range(i, len(dims)):
            prod *= dims[j]
            if prod == t:
                run = dims[i:j + 1]
                if run not in seen:
                    seen.add(run)
                    out.append(run)
            if prod >= t:
                break
    return out


def _serve_signature(arch: ServeArch) -> Tuple:
    # serve_v2: LoRA adapter pricing (adapter_rank/adapter_slots fold
    # in) — rows priced by the pre-adapter formulas can never
    # resurrect into an adapter-aware search, and vice versa
    return ("serve_v2", arch.kv_dtype, arch.act_dtype,
            arch.kv_itemsize, arch.act_itemsize,
            arch.param_itemsize, arch.adapter_rank,
            arch.adapter_slots)


def _serve_fingerprint(mm: H100MachineModel, arch: ServeArch) -> str:
    from .cost_cache import machine_fingerprint
    return machine_fingerprint(mm, serve=_serve_signature(arch))


def price_placement(arch: ServeArch, t: int, mm: H100MachineModel,
                    axis_dims: Tuple[int, ...] = (),
                    cache=None, fingerprint: str = ""
                    ) -> Tuple[float, float]:
    """(decode_step_s, prefill_step_s) of one candidate, through the
    persistent cost cache when given: rows are stored OpCost-shaped
    (decode in fwd, prefill in bwd) under a key carrying the placement
    AND the full arch signature, inside a fingerprint carrying the
    serve dtypes — either flip misses."""
    key = None
    if cache is not None:
        key = cache.entry_key("serve_step", (t, tuple(axis_dims)),
                              extra=arch.signature())
        row = cache.get(fingerprint, key)
        if row is not None:
            return row.fwd, row.bwd
    dec = simulate_serve_step(arch, t, mm, axis_dims=axis_dims)
    pre = simulate_serve_step(arch, t, mm, axis_dims=axis_dims,
                              lanes=arch.prefill_lanes)
    if cache is not None:
        from .cost_model import OpCost
        cache.put(fingerprint, key,
                  OpCost(fwd=dec, bwd=pre, fwd_comm=0.0, bwd_comm=0.0,
                         sync=0.0, mem=0.0))
    return dec, pre


def resident_penalty(arch: ServeArch, t: int, mm: H100MachineModel,
                     resident_bytes: float) -> float:
    """The memory penalty that ``resident_bytes`` held beside a degree
    t > 1's shards add to its step (0 at t = 1, whose shards are the
    whole parameters)."""
    if t <= 1 or not resident_bytes:
        return 0.0
    b = serve_device_bytes(arch, t)
    return mm.memory_penalty(b + float(resident_bytes)) \
        - mm.memory_penalty(b)


def optimize_serve(arch: ServeArch, num_devices: int, *,
                   mm: Optional[H100MachineModel] = None,
                   config=None, budget: int = 64, alpha: float = 0.05,
                   seed: Optional[int] = None,
                   disaggregated: bool = False,
                   resident_bytes: float = 0.0):
    """Pick the serve placement by simulated annealing over
    (degree, axis assignment) — the reference's Metropolis walk with
    the training search's relative-delta acceptance — then return
    the best placement visited with its per-degree decode table.

    `config` (an FFConfig) supplies the machine model file, cost-cache
    path and seed the training search uses, so `serve_mesh="auto"`
    prices serving on exactly the machine the training side was
    calibrated against. The space is small (divisor degrees × torus
    runs), so the default budget walks it to the optimum; the walk —
    not enumeration — is kept so richer placement spaces (replica
    counts, per-layer degrees) extend without restructuring.

    ``disaggregated=True`` searches the SPLIT serving space instead
    (prefill:decode engine ratio × per-role tensor degree, the page-
    handoff link priced on the host link) and returns a
    :class:`DisaggPlacement` — see :func:`optimize_serve_disagg`.

    ``resident_bytes`` (the port's, not JAX's; default 0 prices as
    JAX does): bytes every degree above 1 holds on each device beside
    its shards — the model's own parameters when it lives on the card
    (``serve.engine.card_param_bytes``), 0 for a model kept on the
    host, which prices exactly as JAX does — added to the memory
    penalty's input."""
    if disaggregated:
        return optimize_serve_disagg(arch, num_devices, mm=mm,
                                     config=config, seed=seed)
    if mm is None:
        mm = _machine.default_machine_model(
            machine_file=getattr(config, "machine_model_file", None)
            if config is not None else None)
    if seed is None:
        seed = int(getattr(config, "seed", 0) or 0) \
            if config is not None else 0
    cache = None
    fingerprint = ""
    if config is None or getattr(config, "search_cost_cache", True):
        from .cost_cache import CostCache
        cache = CostCache.open(
            (getattr(config, "cost_cache_file", None) or None)
            if config is not None else None)
        fingerprint = _serve_fingerprint(mm, arch)

    degrees = candidate_degrees(arch, num_devices)
    space: List[Tuple[int, Tuple[int, ...]]] = [
        (t, dims) for t in degrees for dims in axis_assignments(mm, t)]

    def cost_of(cand) -> Tuple[float, float, float]:
        t, dims = cand
        dec, pre = price_placement(arch, t, mm, dims, cache=cache,
                                   fingerprint=fingerprint)
        extra = resident_penalty(arch, t, mm, resident_bytes)
        dec, pre = dec + extra, pre + extra
        return dec + PREFILL_WEIGHT * pre, dec, pre

    rng = random.Random(seed)
    walk_budget = max(len(space), int(budget))
    trace = None
    if config is None or getattr(config, "search_trace", True):
        from .trace import SearchTrace
        trace = SearchTrace(budget=walk_budget)
    cur = (1, ())
    cur_cost, cur_dec, cur_pre = cost_of(cur)
    best, best_cost = cur, cur_cost
    best_dec, best_pre = cur_dec, cur_pre
    if trace is not None:
        trace.record_best(-1, 0, best_cost)
    # every legal degree is priced once up front (flat ring) so the
    # returned per-degree table is complete — the paper's exhaustive
    # per-op config enumeration, affordable here because degrees are
    # few; the walk then also explores axis assignments
    decode_by_degree: Dict[int, float] = {}
    for t in degrees:
        c, dec, pre = cost_of((t, ()))
        decode_by_degree[t] = dec
        if c < best_cost:
            best, best_cost = (t, ()), c
            best_dec, best_pre = dec, pre
            if trace is not None:
                trace.record_best(-1, 0, best_cost)
    for it in range(walk_budget):
        nxt = space[rng.randrange(len(space))]
        if nxt == cur:
            continue
        nxt_cost, nxt_dec, nxt_pre = cost_of(nxt)
        t = nxt[0]
        if nxt_dec < decode_by_degree.get(t, float("inf")):
            decode_by_degree[t] = nxt_dec
        delta = nxt_cost - cur_cost
        temp = alpha * cur_cost
        accepted = delta <= 0 or rng.random() < math.exp(
            -delta / max(1e-12, temp))
        if accepted:
            cur, cur_cost = nxt, nxt_cost
            if cur_cost < best_cost:
                best, best_cost = cur, cur_cost
                best_dec, best_pre = nxt_dec, nxt_pre
                if trace is not None:
                    trace.record_best(it, 0, best_cost)
        if trace is not None:  # observation only, after the decision —
            # traced and untraced walks consume the RNG identically
            trace.record(it, 0, "serve_place",
                         f"t={t} dims={tuple(nxt[1])}", delta,
                         accepted, temp, "serve")
    if cache is not None:
        cache.flush()
    return ServePlacement(
        tensor_parallel=best[0], axis_dims=tuple(best[1]),
        decode_step_s=best_dec, prefill_step_s=best_pre,
        cost=best_cost, decode_by_degree=dict(
            sorted(decode_by_degree.items())),
        fingerprint=fingerprint,
        trace=trace.summary() if trace is not None else None)


# ---------------------------------------------------------------------------
# 2-D (tensor x data) serve mesh placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshTraffic:
    """The traffic model the 2-D mesh objective prices a pool against:
    an aggregate arrival rate split across the replica count, a
    prefix-affinity hit rate over shared preambles (discounted as
    replicas multiply — each replica's cache must see a preamble once
    before it hits), and the SLO targets that turn throughput into
    goodput. Every field folds into the mesh cost-cache fingerprint
    (:func:`_mesh_fingerprint`), so an SLO or rate flip is a
    guaranteed cache miss."""
    arrival_rps: float = 8.0
    # fraction of a steady-state prompt's tokens served from the
    # prefix cache when ONE replica has seen the preamble
    prefix_hit: float = 0.0
    # how many requests share each preamble (tenant fan-in): the
    # hit-rate discount spreads each preamble's one-per-replica cold
    # prefill over this many requests
    requests_per_preamble: float = 8.0
    slo_ttft_s: float = 0.0     # 0 = unbounded
    slo_tpot_s: float = 0.0

    @classmethod
    def from_config(cls, config=None, **over) -> "MeshTraffic":
        """SLO targets from FFConfig's slo_ttft_ms/slo_tpot_ms;
        any field overridable by keyword."""
        kw = {}
        if config is not None:
            tt = float(getattr(config, "slo_ttft_ms", 0.0) or 0.0)
            tp = float(getattr(config, "slo_tpot_ms", 0.0) or 0.0)
            if tt:
                kw["slo_ttft_s"] = tt / 1e3
            if tp:
                kw["slo_tpot_s"] = tp / 1e3
        kw.update(over)
        return cls(**kw)

    def signature(self) -> Tuple:
        return ("mesh_v1", float(self.arrival_rps),
                float(self.prefix_hit),
                float(self.requests_per_preamble),
                float(self.slo_ttft_s), float(self.slo_tpot_s))


def _mesh_fingerprint(mm: H100MachineModel, arch: ServeArch,
                      traffic: MeshTraffic) -> str:
    """The 1-D serve fingerprint widened with the traffic/SLO tuple:
    mesh rows can never resurrect across a kv-dtype, adapter-geometry,
    arrival-rate or SLO-target flip (the acceptance-criteria miss
    guarantee — step prices don't depend on the SLO, but pricing them
    under the wider scope trades a few re-simulations for a fingerprint
    a test can audit field by field)."""
    from .cost_cache import machine_fingerprint
    return machine_fingerprint(
        mm, serve=_serve_signature(arch) + traffic.signature())


@dataclasses.dataclass(frozen=True)
class ServeMeshPlacement:
    """One 2-D (tensor x data) pool placement the mesh search priced
    (the winner when returned by optimize_serve_mesh): shard the mixed
    program ``tensor_parallel`` ways, run ``replicas`` data-parallel
    copies of it (t*r <= the device budget), each axis riding the
    recorded torus dims (() = flat ring). ``table`` is the full priced
    (t, r) grid — what the autoscaler's target pricing and the
    chosen-vs-rejected explain render read — and ``infeasible`` the
    degrees whose per-device residency (serve_device_bytes: weight
    shard + KV pool + adapter pool) overflows HBM: rejected before
    pricing, never penalty-priced."""
    tensor_parallel: int
    replicas: int
    tensor_axis_dims: Tuple[int, ...]
    data_axis_dims: Tuple[int, ...]
    decode_step_s: float
    prefill_step_s: float
    mixed_step_s: float
    goodput_per_s: float
    cost: float
    num_devices: int = 0
    # (t, r) -> cell metrics dict (goodput_per_s, capacity_rps,
    # tokens_per_s, tpot_s, ttft_s, decode/prefill/mixed_step_s,
    # slo_ok, device_bytes) for every FEASIBLE cell
    table: Dict[Tuple[int, int], dict] = dataclasses.field(
        default_factory=dict)
    # HBM-rejected degrees: {"tensor", "device_bytes", "hbm_capacity",
    # "reason"} — one entry per rejected t (every r shares the verdict)
    infeasible: Tuple[dict, ...] = ()
    # per-degree decode step at the flat ring (feasible degrees only):
    # the 1-D table shape the autoscaler's fallback pricing reads
    decode_by_degree: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    traffic: Optional[dict] = None
    fingerprint: str = ""
    trace: Optional[dict] = None

    def cell(self, t: int, r: int) -> Optional[dict]:
        return self.table.get((int(t), int(r)))

    def _best_goodput(self, pred) -> float:
        vals = [c["goodput_per_s"] for k, c in self.table.items()
                if pred(k)]
        return max(vals) if vals else 0.0

    def goodput_gain_vs_tensor_only(self) -> float:
        """Chosen cell's goodput over the best r=1 (pure tensor)
        column — one of the two degenerate baselines the bench gates."""
        base = self._best_goodput(lambda k: k[1] == 1)
        return self.goodput_per_s / max(base, 1e-12)

    def goodput_gain_vs_replicas_only(self) -> float:
        """Chosen cell's goodput over the best t=1 (pure replicas)
        row; infinite when t=1 never fit HBM (the rejection IS the
        win)."""
        base = self._best_goodput(lambda k: k[0] == 1)
        return self.goodput_per_s / max(base, 1e-12)


def price_mesh_step(arch: ServeArch, t: int, mm: H100MachineModel,
                    axis_dims: Tuple[int, ...] = (), cache=None,
                    fingerprint: str = ""
                    ) -> Tuple[float, float, float]:
    """(decode_step_s, prefill_step_s, mixed_step_s) of one tensor
    degree, through the persistent cost cache when given — the mesh
    search's step-price row (the 1-D row plus the mixed-width step the
    pool's TPOT actually runs at), stored under the WIDENED mesh
    fingerprint + the full arch signature."""
    key = None
    if cache is not None:
        key = cache.entry_key("serve_mesh_step", (t, tuple(axis_dims)),
                              extra=arch.signature())
        row = cache.get(fingerprint, key)
        if row is not None:
            return row.fwd, row.bwd, row.fwd_comm
    dec = simulate_serve_step(arch, t, mm, axis_dims=axis_dims)
    pre = simulate_serve_step(arch, t, mm, axis_dims=axis_dims,
                              lanes=arch.prefill_lanes)
    mixed = simulate_serve_step(
        arch, t, mm, axis_dims=axis_dims,
        lanes=arch.decode_lanes + arch.prefill_lanes)
    if cache is not None:
        from .cost_model import OpCost
        cache.put(fingerprint, key,
                  OpCost(fwd=dec, bwd=pre, fwd_comm=mixed,
                         bwd_comm=0.0, sync=0.0, mem=0.0))
    return dec, pre, mixed


def mesh_cell_metrics(arch: ServeArch, t: int, r: int, dec: float,
                      pre: float, mixed: float,
                      traffic: MeshTraffic) -> dict:
    """The pool-level objective of one feasible (t, r) cell: compose
    the per-replica step prices with the traffic model into
    goodput-under-SLO.

    Steady state: each request decodes ``decode_tokens`` tokens on a
    lane of the mixed-width step (TPOT = the mixed step — decode lanes
    pay for the prefill budget riding along) and prefills the NON-hit
    fraction of its context in budget-sized chunks. The prefix-hit
    discount shrinks with r (each replica's cache must ingest a
    preamble once, amortized over the requests sharing it), which is
    exactly the force pulling AGAINST replicas that the 2-D search
    trades off. Capacity is r requests in flight per per-request
    seconds; TTFT is the prefill time inflated by 1/(1-rho) queueing
    as utilization approaches saturation; goodput is arrival capped by
    capacity, zeroed when either SLO target (when set) is violated."""
    dtok = max(1, int(getattr(arch, "decode_tokens", 64)))
    h = float(traffic.prefix_hit) * max(
        0.0, 1.0 - (r - 1.0) / max(1.0, traffic.requests_per_preamble))
    h = min(1.0, max(0.0, h))
    fresh_tokens = arch.context * (1.0 - h)
    chunks = max(1, math.ceil(fresh_tokens / max(1, arch.prefill_lanes)))
    per_request_s = (mixed * dtok / max(1, arch.decode_lanes)
                     + pre * chunks)
    capacity_rps = r / max(1e-12, per_request_s)
    rho = min(0.999, traffic.arrival_rps / max(1e-12, capacity_rps))
    tpot_s = mixed
    ttft_s = pre * chunks / (1.0 - rho)
    slo_ok = not ((traffic.slo_tpot_s and tpot_s > traffic.slo_tpot_s)
                  or (traffic.slo_ttft_s
                      and ttft_s > traffic.slo_ttft_s))
    goodput = min(traffic.arrival_rps, capacity_rps) if slo_ok else 0.0
    return {
        "tensor": t, "replicas": r,
        "goodput_per_s": goodput,
        "capacity_rps": capacity_rps,
        # pool decode-token throughput ceiling — what the autoscaler's
        # demand gauge (decode tokens/s) compares against
        "tokens_per_s": r * arch.decode_lanes / max(1e-12, mixed),
        "tpot_s": tpot_s, "ttft_s": ttft_s,
        "prefix_hit_effective": h,
        "prefill_chunks": chunks,
        "decode_step_s": dec, "prefill_step_s": pre,
        "mixed_step_s": mixed,
        "slo_ok": bool(slo_ok),
    }


def optimize_serve_mesh(arch: ServeArch, num_devices: int, *,
                        mm: Optional[H100MachineModel] = None,
                        config=None,
                        traffic: Optional[MeshTraffic] = None,
                        budget: int = 96, alpha: float = 0.05,
                        seed: Optional[int] = None,
                        fixed_tensor: Optional[int] = None,
                        fixed_replicas: Optional[int] = None,
                        resident_bytes: float = 0.0
                        ) -> ServeMeshPlacement:
    """The paper's ONE-search discipline applied to the serving pool:
    a single Metropolis walk over 2-D (tensor degree x replica count)
    placements with a torus-axis assignment for each axis, t*r bounded
    by the device budget, priced by the pool-level goodput-under-SLO
    objective (:func:`mesh_cell_metrics`). Degrees whose per-device
    residency overflows HBM are REJECTED up front (never proposed,
    never penalty-priced) — the feasibility frontier is part of the
    answer, recorded in ``infeasible``.

    Every feasible (t, r) is priced once at the flat ring first so the
    returned table is complete (the exhaustive half, affordable
    because the grid is divisors x counts); the walk then explores
    axis assignments under the same accept rule as ``optimize_serve``.
    ``fixed_tensor``/``fixed_replicas`` pin one dimension (an explicit
    serve_mesh="N" beside serve_replicas="auto", or vice versa).
    Step prices persist in the shared CostCache under the widened
    :func:`_mesh_fingerprint`. ``resident_bytes`` counts in every
    degree above 1's residency, as in :func:`optimize_serve`."""
    if mm is None:
        mm = _machine.default_machine_model(
            machine_file=getattr(config, "machine_model_file", None)
            if config is not None else None)
    if traffic is None:
        traffic = MeshTraffic.from_config(config)
    if seed is None:
        seed = int(getattr(config, "seed", 0) or 0) \
            if config is not None else 0
    n = max(1, int(num_devices))
    cache = None
    fingerprint = ""
    if config is None or getattr(config, "search_cost_cache", True):
        from .cost_cache import CostCache
        cache = CostCache.open(
            (getattr(config, "cost_cache_file", None) or None)
            if config is not None else None)
        fingerprint = _mesh_fingerprint(mm, arch, traffic)

    degrees = candidate_degrees(arch, n)
    if fixed_tensor is not None:
        t0 = int(fixed_tensor)
        if t0 not in degrees:
            raise ValueError(
                f"fixed tensor degree {t0} is not a feasible degree "
                f"for {arch.num_heads} heads on {n} devices")
        degrees = [t0]
    hbm = float(getattr(mm.spec, "hbm_capacity", float("inf")))
    infeasible: List[dict] = []
    feasible: List[int] = []
    for t in degrees:
        b = serve_device_bytes(arch, t) \
            + (float(resident_bytes) if t > 1 else 0.0)
        if b > hbm:
            infeasible.append({
                "tensor": t, "device_bytes": b, "hbm_capacity": hbm,
                "reason": f"per-device residency "
                          f"{b / 2**20:.1f} MiB > HBM "
                          f"{hbm / 2**20:.1f} MiB"})
        else:
            feasible.append(t)
    if not feasible:
        raise ValueError(
            f"no tensor degree fits HBM on this machine "
            f"({[d['reason'] for d in infeasible]})")

    def replica_counts(t: int) -> List[int]:
        top = n // t
        if fixed_replicas is not None:
            rr = int(fixed_replicas)
            return [rr] if 1 <= rr <= top else []
        return list(range(1, top + 1))

    step_cache: Dict[Tuple[int, Tuple[int, ...]], Tuple[float, float,
                                                        float]] = {}

    def steps_of(t: int, dims: Tuple[int, ...]):
        k = (t, tuple(dims))
        if k not in step_cache:
            step_cache[k] = price_mesh_step(
                arch, t, mm, dims, cache=cache, fingerprint=fingerprint)
        return step_cache[k]

    def cost_of(cand) -> Tuple[float, dict]:
        t, r, tdims, _ddims = cand
        dec, pre, mixed = steps_of(t, tdims)
        cell = mesh_cell_metrics(arch, t, r, dec, pre, mixed, traffic)
        # goodput carries the objective; TPOT then TTFT break ties
        # between cells that both sustain the arrival rate (prefer the
        # lower-latency shape), and a vanishing device-count term makes
        # equal-everything ties deterministic
        cost = (-cell["goodput_per_s"] + cell["tpot_s"]
                + 1e-3 * cell["ttft_s"] + 1e-9 * t * r)
        return cost, cell

    # exhaustive flat-ring pricing of the full feasible grid: the
    # returned table must be complete even where the walk never lands
    table: Dict[Tuple[int, int], dict] = {}
    decode_by_degree: Dict[int, float] = {}
    best = None
    best_cost = float("inf")
    best_cell: Optional[dict] = None
    for t in feasible:
        for r in replica_counts(t):
            c, cell = cost_of((t, r, (), ()))
            table[(t, r)] = cell
            decode_by_degree[t] = cell["decode_step_s"]
            if c < best_cost:
                best, best_cost, best_cell = (t, r, (), ()), c, cell
    if best is None:
        raise ValueError(
            f"no (t, r) cell fits {n} devices with "
            f"fixed_tensor={fixed_tensor} "
            f"fixed_replicas={fixed_replicas}")

    space: List[Tuple[int, int, Tuple[int, ...], Tuple[int, ...]]] = [
        (t, r, tdims, ddims)
        for t in feasible for r in replica_counts(t)
        for tdims in axis_assignments(mm, t)
        for ddims in axis_assignments(mm, r)]
    rng = random.Random(seed)
    walk_budget = max(len(space), int(budget))
    trace = None
    if config is None or getattr(config, "search_trace", True):
        from .trace import SearchTrace
        trace = SearchTrace(budget=walk_budget)
        trace.record_best(-1, 0, best_cost)
    cur, cur_cost = best, best_cost
    for it in range(walk_budget):
        nxt = space[rng.randrange(len(space))]
        if nxt == cur:
            continue
        nxt_cost, nxt_cell = cost_of(nxt)
        cell_key = (nxt[0], nxt[1])
        if nxt_cell["goodput_per_s"] >= table[cell_key][
                "goodput_per_s"] and nxt[2] != ():
            # a torus-assigned step that beats the flat ring upgrades
            # the table's cell (the table records each cell's BEST)
            if nxt_cost < cost_of((nxt[0], nxt[1], (), ()))[0]:
                table[cell_key] = nxt_cell
        delta = nxt_cost - cur_cost
        temp = alpha * max(1e-12, abs(cur_cost))
        accepted = delta <= 0 or rng.random() < math.exp(
            -delta / max(1e-12, temp))
        if accepted:
            cur, cur_cost = nxt, nxt_cost
            if cur_cost < best_cost:
                best, best_cost, best_cell = cur, cur_cost, nxt_cell
                if trace is not None:
                    trace.record_best(it, 0, best_cost)
        if trace is not None:  # observation only, after the decision —
            # traced and untraced walks consume the RNG identically
            trace.record(it, 0, "serve_mesh",
                         f"t={nxt[0]} r={nxt[1]} "
                         f"tdims={tuple(nxt[2])} "
                         f"ddims={tuple(nxt[3])}", delta,
                         accepted, temp, "serve")
    if cache is not None:
        cache.flush()
    t, r, tdims, ddims = best
    return ServeMeshPlacement(
        tensor_parallel=t, replicas=r,
        tensor_axis_dims=tuple(tdims), data_axis_dims=tuple(ddims),
        decode_step_s=best_cell["decode_step_s"],
        prefill_step_s=best_cell["prefill_step_s"],
        mixed_step_s=best_cell["mixed_step_s"],
        goodput_per_s=best_cell["goodput_per_s"],
        cost=best_cost, num_devices=n,
        table=dict(sorted(table.items())),
        infeasible=tuple(infeasible),
        decode_by_degree=dict(sorted(decode_by_degree.items())),
        traffic=dict(zip(("version", "arrival_rps", "prefix_hit",
                          "requests_per_preamble", "slo_ttft_s",
                          "slo_tpot_s"), traffic.signature())),
        fingerprint=fingerprint,
        trace=trace.summary() if trace is not None else None)


# ---------------------------------------------------------------------------
# Disaggregated prefill/decode placement (serve/disagg.py's search half)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DisaggPlacement:
    """One disaggregated serving placement the search priced: how many
    dedicated prefill vs decode engines to run (at which per-role
    tensor degrees), with the page-handoff link costed on the host
    link. ``ratio_table`` maps "p:d" engine ratios to their best
    steady-state per-request seconds (per-role degrees optimized away)
    — the disaggregated mirror of ServePlacement.decode_by_degree."""

    prefill_engines: int
    prefill_tensor: int
    decode_engines: int
    decode_tensor: int
    # steady-state components of the winning candidate (seconds)
    decode_step_s: float        # one decode-engine step — the TPOT floor
    prefill_step_s: float       # one budget-wide prefill-engine step
    transfer_s: float           # one request's page handoff on the link
    bottleneck_s: float         # slowest pipeline stage, per request
    cost: float
    # "p:d" -> best per-request seconds at that engine ratio
    ratio_table: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # the unified baseline at the same device count (optimize_serve's
    # winner run as num_devices/t data-parallel replicas): its TPOT is
    # the full mixed-width step — what the A/B's reduction is against
    unified_tpot_s: float = 0.0
    unified_per_request_s: float = 0.0
    fingerprint: str = ""

    @property
    def ratio(self) -> str:
        return f"{self.prefill_engines}:{self.decode_engines}"

    def tpot_reduction_vs_unified(self) -> float:
        """Simulated TPOT win of the split: the unified engine's
        mixed-width step over the decode engine's decode-only step.
        Degrades to 1.0 with a warning when the unified baseline was
        never priced (a partial-budget search)."""
        if not self.unified_tpot_s:
            warnings.warn(
                "disagg placement has no unified-baseline TPOT; "
                "reporting tpot_reduction_vs_unified as 1.0x",
                RuntimeWarning, stacklevel=2)
            return 1.0
        if not self.decode_step_s:
            return 1.0
        return self.unified_tpot_s / self.decode_step_s


def price_disagg_candidate(arch: ServeArch, t_pre: int, t_dec: int,
                           mm: H100MachineModel, *, cache=None,
                           fingerprint: str = ""
                           ) -> Tuple[float, float, float]:
    """(prefill_step_s, decode_step_s, transfer_s) of one per-role
    degree pair, through the persistent cost cache when given.

    The prefill engine's step is the budget-wide mixed program at
    ``t_pre``; the decode engine's step is its REAL fixed program —
    ``decode_lanes`` query lanes plus the ``handoff_stub_lanes``
    prefill stub that recomputes handoff tails (no full prefill
    budget riding along, the whole point of the split) — at
    ``t_dec``, priced WITH the
    steady-state page-handoff load importing beside it
    (cost_model.serve_step_tasks): the decode engine turns over its
    ``decode_lanes`` requests every ``decode_tokens`` steps, so each
    step imports ``context * decode_lanes / decode_tokens`` tokens'
    pages on average; the transfer term itself is the host-link
    seconds of one full context's pages — what the ratio balance
    weighs against freed compute. Cached rows carry the full arch
    signature (kv dtype/itemsize included), so a KV-dtype flip is a
    guaranteed miss AND a changed transfer price."""
    key = None
    if cache is not None:
        key = cache.entry_key("serve_disagg", (t_pre, t_dec),
                              extra=arch.signature())
        row = cache.get(fingerprint, key)
        if row is not None:
            return row.fwd, row.bwd, row.sync
    pre = simulate_serve_step(arch, t_pre, mm,
                              lanes=arch.prefill_lanes)
    per_step_tokens = max(1, round(
        arch.context * arch.decode_lanes
        / max(1, getattr(arch, "decode_tokens", 64))))
    dec_lanes = arch.decode_lanes + int(
        getattr(arch, "handoff_stub_lanes", 32))
    dec = simulate_serve_step(arch, t_dec, mm, lanes=dec_lanes,
                              transfer_tokens=per_step_tokens)
    xfer = mm.host_transfer(kv_handoff_bytes(arch))
    if cache is not None:
        from .cost_model import OpCost
        cache.put(fingerprint, key,
                  OpCost(fwd=pre, bwd=dec, fwd_comm=0.0, bwd_comm=0.0,
                         sync=xfer, mem=0.0))
    return pre, dec, xfer


def optimize_serve_disagg(arch: ServeArch, num_devices: int, *,
                          mm: Optional[H100MachineModel] = None,
                          config=None,
                          seed: Optional[int] = None
                          ) -> DisaggPlacement:
    """Pick the prefill:decode split — engine counts × per-role tensor
    degrees — whose steady-state per-request bottleneck is smallest:
    the SOAP don't-hand-tune-it discipline applied to the
    disaggregation axis (ROADMAP).

    Steady state under mixed traffic: every request prefills its
    ``context`` tokens in budget-sized chunks on SOME prefill engine,
    ships its pages over the host link once, and decodes
    ``decode_tokens`` tokens on a decode-lane of SOME decode engine.
    Each stage's per-request seconds:

      prefill  = prefill_step_s * ceil(context/prefill_lanes) / p
      transfer = host_transfer(kv_handoff_bytes) / p   (one DMA link
                 per prefill engine's host)
      decode   = decode_step_s * decode_tokens / decode_lanes / d

    and the pipeline sustains 1/max(stages) requests per second. The
    objective is that bottleneck plus ``PREFILL_WEIGHT`` × the decode
    step (TTFT already carries the prefill weight in the unified
    objective; here the extra term keeps a ratio that wrecks TPOT from
    winning on raw throughput). The space is small (ratios × divisor
    degrees), so it is enumerated exhaustively — the per-op
    exhaustive-config half of the reference search — and the full
    ratio table is returned the way optimize_serve returns the
    per-degree decode table."""
    if mm is None:
        mm = _machine.default_machine_model(
            machine_file=getattr(config, "machine_model_file", None)
            if config is not None else None)
    n = max(2, int(num_devices))
    cache = None
    fingerprint = ""
    if config is None or getattr(config, "search_cost_cache", True):
        from .cost_cache import CostCache
        cache = CostCache.open(
            (getattr(config, "cost_cache_file", None) or None)
            if config is not None else None)
        fingerprint = _serve_fingerprint(mm, arch)

    degrees = candidate_degrees(arch, n)
    chunks_per_prompt = max(1.0, math.ceil(
        arch.context / max(1, arch.prefill_lanes)))
    dec_tokens = max(1, int(getattr(arch, "decode_tokens", 64)))

    best = None
    best_cost = float("inf")
    ratio_table: Dict[str, float] = {}
    # each role's step cost depends on ITS degree only (the transfer
    # term on neither), so one pricing per degree covers every
    # (t_pre, t_dec) pair — O(D) simulations, not O(D^2)
    priced = {t: price_disagg_candidate(arch, t, t, mm, cache=cache,
                                        fingerprint=fingerprint)
              for t in degrees}
    for t_pre in degrees:
        pre = priced[t_pre][0]
        for t_dec in degrees:
            dec, xfer = priced[t_dec][1], priced[t_dec][2]
            p_max = (n - t_dec) // t_pre
            if p_max < 1:
                continue
            for p in range(1, p_max + 1):
                d = (n - p * t_pre) // t_dec
                if d < 1:
                    continue
                stage_pre = pre * chunks_per_prompt / p
                stage_xfer = xfer / p
                stage_dec = dec * dec_tokens / max(
                    1, arch.decode_lanes) / d
                bottleneck = max(stage_pre, stage_xfer, stage_dec)
                cost = bottleneck + PREFILL_WEIGHT * dec
                ratio = f"{p}:{d}"
                if bottleneck < ratio_table.get(ratio, float("inf")):
                    ratio_table[ratio] = bottleneck
                if cost < best_cost:
                    best_cost = cost
                    best = (p, t_pre, d, t_dec, pre, dec, xfer,
                            bottleneck)
    if best is None:
        raise ValueError(
            f"no disaggregated placement fits {num_devices} devices "
            f"(need >= 1 prefill + 1 decode engine)")

    # the unified baseline at the same device count: optimize_serve's
    # winner replicated data-parallel, its TPOT the FULL mixed-width
    # step (decode lanes pay for the prefill budget every step — the
    # interference disaggregation removes)
    uni = optimize_serve(arch, n, mm=mm, config=config, seed=seed)
    replicas = max(1, n // max(1, uni.tensor_parallel))
    uni_tpot = simulate_serve_step(
        arch, uni.tensor_parallel, mm, axis_dims=uni.axis_dims,
        lanes=arch.decode_lanes + arch.prefill_lanes)
    uni_per_req = (uni_tpot * dec_tokens / max(1, arch.decode_lanes)
                   + uni.prefill_step_s * chunks_per_prompt) / replicas

    if cache is not None:
        cache.flush()
    p, t_pre, d, t_dec, pre, dec, xfer, bottleneck = best

    def _ratio_key(r: str) -> Tuple[int, int]:
        a, b = r.split(":")
        return int(a), int(b)

    return DisaggPlacement(
        prefill_engines=p, prefill_tensor=t_pre,
        decode_engines=d, decode_tensor=t_dec,
        decode_step_s=dec, prefill_step_s=pre, transfer_s=xfer,
        bottleneck_s=bottleneck, cost=best_cost,
        ratio_table=dict(sorted(ratio_table.items(),
                                key=lambda kv: _ratio_key(kv[0]))),
        unified_tpot_s=uni_tpot, unified_per_request_s=uni_per_req,
        fingerprint=fingerprint)
