"""Multi-replica serving tier: prefix-affinity router and autoscaler on
a deterministic virtual clock; the port's copy of
``flexflow_tpu/serve/router.py``.

  * :class:`ReplicaPool` — N ``ServeEngine`` replicas over ONE model,
    each behind a long-lived :class:`~.engine.ServeSession`, serving a
    timed traffic stream (serve/traffic.py) on a VIRTUAL clock: each
    replica's step advances its clock by the cost stack's price of the
    step (``_price``: the engine's drift prediction, the same
    ``simulate_serve_step`` the placement search prices), so
    TTFT/TPOT/goodput under SLO are reproducible numbers and autoscaler
    decisions replay exactly at one seed — while the TOKENS come from
    the real engines, token for token a single-replica engine's. All
    replicas live on one card, each an engine with its own captured
    steps and its own CUDA stream; a shared host tier
    (``host_tier_mb``) serves every replica.
  * the WALL clock (``run(wall_clock=True)``, ``serve_wall_clock``):
    the same traffic in real time, arrivals paced on the wall clock and
    each replica stepping on its own worker thread on its engine's
    stream (``wall_threads=False`` steps them round-robin from one
    thread, the A/B baseline), goodput under SLO a measured number.
  * prefix-affinity routing — the replica whose chain-hash prefix
    registry holds the LONGEST matching prefix of the prompt (one dict
    probe per page-aligned block, extended through the router's pending
    pins), then host-tier and adapter residency, then a tenant-sticky
    hash; a load-aware spill off degradation rung or occupancy.
  * :class:`Autoscaler` — a replica-count control loop reading only
    exported registry gauges, with hysteresis and cooldown, its target
    priced off the placement search's decode table
    (search/serve_place.optimize_serve) or the 2-D mesh table of
    ``serve_replicas="auto"``.

``serve_replicas="auto"`` boots the (tensor, replicas) shape of the 2-D
mesh search (search/serve_place.optimize_serve_mesh), priced over the
process group's world size (the visible cards without a group): r
replicas of degree t, each a tensor-parallel engine over the same t
ranks, as JAX's replicas all sit on its first t devices. On the virtual
clock every rank runs the same pool and takes the same decisions. On
the wall clock every rank runs the pool from one thread, and rank 0's
clock decides for all (``ReplicaPool._run_lockstep``): at each tick
``parallel/collectives.Lockstep.lead`` checks that the ranks hold the
same host state and carries rank 0's arrivals, step order and stamps,
so every rank issues the sharded steps' collectives in one order and
keeps the same records.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.collectives import Lockstep, LockstepError, digest
from ..utils.telemetry import (REQUEST_COMPONENTS, MetricsRegistry,
                               Telemetry, fold_attribution, next_trace_id,
                               pct, pow2_bucket, serve_metrics,
                               telemetry_for, write_json_atomic)
from .adapters import tenant_prefix_salt
from .engine import ServeEngine, ServeSession, StepEvents
from .host_tier import HostPageStore
from .kv_cache import prefix_page_keys
from .scheduler import Request, RequestOutcome
from .traffic import TrafficRequest

__all__ = ["Autoscaler", "Replica", "ReplicaPool"]

_ROUTER_TRACK = ("serve", "router")
_SCALER_TRACK = ("serve", "autoscaler")

# spin guard: consecutive planning-only (non-dispatched) steps one
# replica may return before the pool declares the scheduler wedged
_MAX_PLAN_ONLY = 1000


def _tenant_hash(tenant: int) -> int:
    """Deterministic tenant-sticky hash (Knuth multiplicative — NOT
    Python's hash(), which is process-randomized for str and would
    unseed the router)."""
    return (int(tenant) * 2654435761) & 0xFFFFFFFF


class Replica:
    """One serving replica: an engine, its long-lived session, and the
    virtual clock the simulated cluster advances it on."""

    def __init__(self, idx: int, engine: ServeEngine):
        self.idx = idx
        self.engine = engine
        self.session: ServeSession = engine.start_session()
        self.clock_s = 0.0          # virtual time consumed
        self.busy_s = 0.0           # virtual seconds spent stepping
        self.steps = 0
        self.assigned = 0
        self.tokens = 0
        self.peak_occupancy = 0.0
        self.live = True            # parked (retired, warm) when False
        self.draining = False       # not routable; steps until empty
        self.inflight: set = set()  # stream ids tracked on this replica
        self._plan_only = 0
        # wall-clock mode: the step/submit mutual exclusion (the
        # worker thread holds it across session.step(), the router
        # thread across session.submit()) and the measured wall
        # seconds this replica's steps consumed
        self.lock = threading.Lock()
        self.busy_wall_s = 0.0
        # the zero-recompile baseline: capture counts right after
        # warmup — the router gate compares against THIS snapshot
        self.warm_counts = engine.compile_counts()

    # ---- backpressure signals (the spill + gauge inputs) -------------
    def occupancy(self) -> float:
        c = self.engine.cache_cfg
        return 1.0 - self.engine.cache.free_pages / c.usable_pages

    def rung(self) -> int:
        return int(self.session.sched.rung)

    def queue_depth(self) -> int:
        return len(self.session.sched.waiting)

    def routable(self) -> bool:
        return self.live and not self.draining

    def has_work(self) -> bool:
        return self.live and self.session.has_work()


class Autoscaler:
    """Telemetry-driven replica autoscaler.

    ``evaluate(t_now)`` reads ONLY gauges the pool exported into the
    shared :class:`MetricsRegistry` (serve_pool_ttft_p99_window_s,
    serve_pool_tpot_p99_window_s, serve_pool_occupancy_mean,
    serve_pool_queue_depth, serve_pool_decode_tokens_per_s_window,
    serve_pool_replicas_live, serve_pool_boot_cost_s) — never private
    engine state — so a
    decision is a pure function of (exported metrics, scaler state)
    and replays exactly at one seed. Hysteresis: scale up only after
    ``up_patience`` consecutive hot evaluations, down after
    ``down_patience`` cold ones, with a ``cooldown_s`` dead time
    after every action — a steady load settles, it never flaps.

    The per-degree decode table ``optimize_serve`` returns prices the
    decision: one replica sustains ``decode_lanes /
    decode_table[tp]`` tokens/sec, so the windowed demand divides
    into a TARGET replica count — demand above the live set's priced
    capacity is a scale-up signal even before the SLO breaks, and a
    scale-down is refused while the target says the remaining
    replicas could not carry the load."""

    def __init__(self, registry: MetricsRegistry, *,
                 slo_ttft_s: float = 0.0, slo_tpot_s: float = 0.0,
                 min_replicas: int = 1, max_replicas: int = 4,
                 interval_s: float = 1.0, occ_hi: float = 0.85,
                 occ_lo: float = 0.30, up_patience: int = 2,
                 down_patience: int = 4, cooldown_s: float = 0.0,
                 decode_table: Optional[Dict[int, float]] = None,
                 tensor_parallel: int = 1,
                 decode_lanes: Optional[int] = None,
                 mesh_table: Optional[Dict[Tuple[int, int],
                                           dict]] = None):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got "
                             f"{interval_s}")
        self.registry = registry
        self.slo_ttft_s = float(slo_ttft_s)
        self.slo_tpot_s = float(slo_tpot_s)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval_s = float(interval_s)
        self.occ_hi = float(occ_hi)
        self.occ_lo = float(occ_lo)
        self.up_patience = int(up_patience)
        self.down_patience = int(down_patience)
        self.cooldown_s = float(cooldown_s)
        # priced per-replica capacity from the search's decode table
        # (tokens/sec): lanes per decode step / simulated step seconds
        self.capacity_tps: Optional[float] = None
        if decode_table:
            step_s = decode_table.get(int(tensor_parallel)) \
                or min(decode_table.values())
            if step_s and decode_lanes:
                self.capacity_tps = float(decode_lanes) / float(step_s)
        # the 2-D mesh search's (t, r) price table
        # (ServeMeshPlacement.table): when present, target pricing
        # reads the searched pool-capacity column at THIS degree
        # instead of extrapolating the 1-D decode table — scale
        # decisions and placement agree on one price
        self.tensor_parallel = int(tensor_parallel)
        self.mesh_table = dict(mesh_table) if mesh_table else None
        self.events: List[dict] = []
        self._hot = 0
        self._cold = 0
        self._last_scale_t: Optional[float] = None

    @classmethod
    def from_config(cls, config, registry: MetricsRegistry,
                    **kw) -> "Autoscaler":
        """Build from FFConfig's slo_ttft_ms / slo_tpot_ms /
        serve_autoscale_max knobs (max 0 = 2x serve_replicas)."""
        sr = getattr(config, "serve_replicas", 1)
        n = 1 if isinstance(sr, str) else int(sr)   # "auto": the pool
        #   passes the searched count through max_replicas explicitly
        mx = int(getattr(config, "serve_autoscale_max", 0)) or 2 * n
        kw.setdefault("slo_ttft_s",
                      float(getattr(config, "slo_ttft_ms", 0.0)) / 1e3)
        kw.setdefault("slo_tpot_s",
                      float(getattr(config, "slo_tpot_ms", 0.0)) / 1e3)
        kw.setdefault("max_replicas", mx)
        return cls(registry, **kw)

    def target_replicas(self, demand_tps: float) -> Optional[int]:
        """Priced target count. With a 2-D mesh table: the smallest
        replica count whose searched (t, r) cell sustains the windowed
        token demand at this pool's tensor degree (extrapolated from
        the per-replica capacity past the priced grid). Otherwise the
        1-D path: windowed demand / decode-table capacity. None when
        no table was supplied."""
        if demand_tps <= 0:
            return None
        if self.mesh_table:
            rows = sorted(
                (int(r), cell) for (t, r), cell in
                self.mesh_table.items()
                if int(t) == self.tensor_parallel
                and float(cell.get("tokens_per_s", 0.0)) > 0)
            if rows:
                for r, cell in rows:
                    if float(cell["tokens_per_s"]) >= demand_tps:
                        return max(self.min_replicas, r)
                r1, c1 = rows[0]
                per = float(c1["tokens_per_s"]) / max(1, r1)
                return max(self.min_replicas,
                           math.ceil(demand_tps / per))
        if not self.capacity_tps:
            return None
        return max(self.min_replicas,
                   math.ceil(demand_tps / self.capacity_tps))

    def evaluate(self, t_now: float) -> Optional[dict]:
        """One control tick: returns a decision dict ({"direction":
        "up"|"down", "reason": ...}) or None. The pool applies it and
        emits the telemetry span."""
        m = self.registry
        live = int(m.gauge("serve_pool_replicas_live", 1.0))
        ttft99 = m.gauge("serve_pool_ttft_p99_window_s")
        tpot99 = m.gauge("serve_pool_tpot_p99_window_s")
        occ = m.gauge("serve_pool_occupancy_mean")
        queue = m.gauge("serve_pool_queue_depth")
        demand = m.gauge("serve_pool_decode_tokens_per_s_window")
        # what the NEXT scale-up costs (serve_pool_boot_cost_s,
        # ProgramRegistry-measured compile seconds): ~0 when a parked
        # replica or a --program-cache-dir snapshot makes the boot
        # warm, the measured compile storm when it would be cold —
        # attached to the decision so the cost is planning-visible
        # (it never gates the decision itself: an overloaded pool
        # must still scale, just with its eyes open)
        boot_s = m.gauge("serve_pool_boot_cost_s")
        target = self.target_replicas(demand)

        reasons = []
        if self.slo_ttft_s and ttft99 > self.slo_ttft_s:
            reasons.append(f"ttft_p99 {ttft99*1e3:.1f}ms > SLO")
        if self.slo_tpot_s and tpot99 > self.slo_tpot_s:
            reasons.append(f"tpot_p99 {tpot99*1e3:.1f}ms > SLO")
        if occ >= self.occ_hi:
            reasons.append(f"occupancy {occ:.0%} >= {self.occ_hi:.0%}")
        if target is not None and target > live:
            reasons.append(f"priced target {target} > {live} live")
        hot = bool(reasons)
        cold = (occ <= self.occ_lo and queue == 0
                and (not self.slo_ttft_s
                     or ttft99 <= 0.5 * self.slo_ttft_s)
                and (not self.slo_tpot_s
                     or tpot99 <= 0.75 * self.slo_tpot_s))
        self._hot = self._hot + 1 if hot else 0
        self._cold = self._cold + 1 if cold else 0
        if self._last_scale_t is not None and \
                t_now - self._last_scale_t < self.cooldown_s:
            return None
        decision = None
        if self._hot >= self.up_patience and live < self.max_replicas:
            decision = {"direction": "up",
                        "reason": "; ".join(reasons)}
        elif self._cold >= self.down_patience \
                and live > self.min_replicas \
                and (target is None or target < live):
            decision = {"direction": "down",
                        "reason": f"occupancy {occ:.0%} <= "
                                  f"{self.occ_lo:.0%}, queue empty, "
                                  f"latency well under SLO"}
        if decision is not None:
            decision.update(
                t=t_now, live=live, ttft_p99_s=ttft99,
                tpot_p99_s=tpot99, occupancy=occ, queue_depth=queue,
                demand_tokens_per_s=demand, priced_target=target,
                boot_s=boot_s)
            self.events.append(decision)
            self._hot = self._cold = 0
            self._last_scale_t = t_now
        return decision


class ReplicaPool:
    """N serving replicas over one model, behind the prefix-affinity
    router, driven on a deterministic virtual clock (module
    docstring). ``run(traffic, ...)`` serves a seeded
    :mod:`~.traffic` stream and returns (and stashes on
    ``last_stats``) the per-request records + goodput-under-SLO the
    bench A/Bs; :meth:`route`/:meth:`submit`/:meth:`step_next` are
    the underlying pieces the tests drive directly."""

    def __init__(self, model, num_replicas: Optional[int] = None, *,
                 policy: Optional[str] = None, config=None,
                 telemetry: Optional[Telemetry] = None,
                 spill_rung: int = 3, spill_occupancy: float = 0.90,
                 window_s: float = 2.0, device="cuda",
                 engine_kwargs=None):
        self.model = model
        cfg = config if config is not None else model.config
        self.config = cfg
        engine_kwargs = dict(engine_kwargs or {})
        engine_kwargs.setdefault("device", device)
        # serve_replicas="auto": ONE search prices tensor degree x
        # replica count over the process group's world size (the
        # visible cards without a group) and the pool boots the
        # searched (t, r) shape; an explicit serve_mesh N (or
        # engine_kwargs' tensor_parallel) pins the degree. The placement
        # is kept on self.mesh_placement (the autoscaler's target
        # pricing and router_report read it)
        self.mesh_placement = None
        sr = cfg.serve_replicas
        if num_replicas is None and isinstance(sr, str) \
                and sr.strip() == "auto":
            from ..parallel.mesh import serve_devices
            from ..search.serve_place import optimize_serve_mesh
            from ..config import CompMode, resolve_device
            from .engine import card_param_bytes, probe_serve_arch
            sm = str(cfg.serve_mesh or "").strip()
            fixed_t = int(sm) if sm and sm != "auto" else None
            if "tensor_parallel" in engine_kwargs:
                fixed_t = int(engine_kwargs["tensor_parallel"])
            arch = probe_serve_arch(model, cfg)
            if model.state is None:
                model.compile(comp_mode=CompMode.INFERENCE)
            # a degree above 1 holds the model's own parameters on its
            # card beside its shards when the model lives there, none
            # of a model on the host (ServeEngine.memory_ledger)
            place = optimize_serve_mesh(
                arch, serve_devices(), config=cfg, fixed_tensor=fixed_t,
                resident_bytes=card_param_bytes(
                    model, resolve_device(engine_kwargs["device"])))
            self.mesh_placement = place
            num_replicas = place.replicas
            engine_kwargs.setdefault("tensor_parallel",
                                     place.tensor_parallel)
        if num_replicas is None:
            num_replicas = int(sr)
        if num_replicas < 1:
            raise ValueError(
                f"need >= 1 replica, got {num_replicas}")
        self.policy = policy if policy is not None \
            else str(cfg.router_policy)
        if self.policy not in ("affinity", "round_robin"):
            raise ValueError(
                f"router policy must be 'affinity' or 'round_robin', "
                f"got {self.policy!r}")
        self.telemetry = telemetry if telemetry is not None \
            else telemetry_for(cfg)
        # the pool-lifetime registry: replica-labeled latency folds,
        # router/autoscaler counters, and the gauges the autoscaler
        # reads. The bus's registry when telemetry is on (one scrape
        # surface), else the pool's own — never the shared disabled
        # singleton's (the DisaggCluster idiom).
        self.metrics = self.telemetry.metrics if self.telemetry.enabled \
            else MetricsRegistry()
        self.spill_rung = int(spill_rung)
        self.spill_occupancy = float(spill_occupancy)
        self.window_s = float(window_s)
        self._engine_kwargs = dict(engine_kwargs or {})
        # ONE shared host tier for the whole pool (hierarchical
        # prefix cache, serve/host_tier.py): every replica spills
        # into and reloads from the same store, so a tenant's
        # preamble crosses HBM once per replica instead of once per
        # request. An explicit engine_kwargs["host_tier"] wins (tests
        # inject a store); otherwise --host-tier-mb arms it.
        ht = self._engine_kwargs.get("host_tier")
        if ht is None and bool(cfg.serve_host_tier) \
                and float(cfg.host_tier_mb) > 0:
            ht = HostPageStore(float(cfg.host_tier_mb))
        self.host_tier: Optional[HostPageStore] = ht
        if ht is not None:
            self._engine_kwargs["host_tier"] = ht
        # pool-wide adapter registry (tenant -> (weights, scale)):
        # replayed onto every replica — including engines the
        # autoscaler builds later — so any replica can serve any
        # registered tenant (serve/adapters.py)
        self._adapter_registry: Dict[int, tuple] = {}
        self.replicas: List[Replica] = []
        self._pins: List[Dict[bytes, int]] = []
        self._rr_next = 0
        self._sample_seed = 0
        self._inflight: Dict[int, dict] = {}    # stream id -> tracked
        self._records: Dict[int, dict] = {}
        self._req_refs: Dict[int, Request] = {}  # stream id -> Request
        self._w_first: deque = deque()   # (t_first, ttft)
        self._w_done: deque = deque()    # (t_finish, tpot, tokens)
        # which clock the CURRENT run's latency stamps are on
        # ("virtual" | "wall") — _finalize labels its exported
        # histograms with it, so wall-mode samples can never pollute
        # the serve_router_*_virtual_seconds series (and vice versa)
        self._clock = "virtual"
        self._next_eval = 0.0
        self.scale_events: List[dict] = []
        self.stats = {"routed": 0, "affinity_hits": 0,
                      "host_hits": 0,
                      "adapter_affinity_hits": 0, "spills": 0,
                      "fallbacks": 0, "cancels_sent": 0,
                      "scale_ups": 0, "scale_downs": 0}
        self.last_stats: Optional[dict] = None
        # most recent replica-boot record (_activate_replica): warm vs
        # cold, wall seconds, and the registry's measured compile
        # seconds — exported as serve_pool_boot_cost_s so the
        # autoscaler's scale-up decision prices the boot it is about
        # to pay
        self._last_boot: Optional[dict] = None
        for _ in range(int(num_replicas)):
            self._activate_replica(0.0)
        # the pool owns the scrape endpoint (replica engines are built
        # with metrics_port=None): one /metrics page serves the whole
        # tier — labeled latency series, router counters, autoscaler
        # gauges — exactly what an external autoscaler would poll
        self.metrics_server = None
        if cfg.metrics_port is not None:
            from ..utils.telemetry import MetricsServer
            self.metrics_server = MetricsServer(
                self.metrics.to_prometheus, port=int(cfg.metrics_port),
                host=str(cfg.metrics_host))

    @classmethod
    def from_config(cls, model, **kw) -> "ReplicaPool":
        """serve_replicas / router_policy construction."""
        return cls(model, **kw)

    # ---------------- replica lifecycle --------------------------------
    def _new_engine(self) -> ServeEngine:
        # a replica serves through its session: the chunked mixed step;
        # the pool owns the one /metrics endpoint
        role_cfg = dataclasses.replace(self.config, metrics_port=None,
                                       serve_chunked_prefill=True)
        return ServeEngine(self.model, role_cfg, telemetry=self.telemetry,
                           **self._engine_kwargs)

    def _activate_replica(self, t_now: float) -> Replica:
        """Scale-up primitive, cheapest boot first: reactivate a
        PARKED warm replica (captured programs intact — zero new
        captures); else build and warm up a fresh engine, warm or cold
        as its ``boot_stats`` say: with ``program_cache_dir`` armed, once
        a store covers the configuration (the first engine over it
        writes one), a fresh engine loads its kernels from the cache and
        captures every stored signature in ``warmup`` — a
        `replica_boot_warm` span; without one, a `replica_boot_cold`.
        Every non-parked boot's span carries the registry's measured
        capture seconds, and the latest boot cost feeds the
        serve_pool_boot_cost_s gauge the autoscaler prices scale-ups
        with. The new replica's clock fast-forwards to now (a replica
        cannot serve the past)."""
        for r in self.replicas:
            if not r.live:
                r.live = True
                r.draining = False
                r.clock_s = max(r.clock_s, t_now)
                self._last_boot = {"warm": True, "parked": True,
                                   "boot_s": 0.0, "compile_s": 0.0,
                                   "restored": 0, "compiles": 0}
                return r
        w0 = time.perf_counter()
        eng = self._new_engine()
        for t, (w, sc) in sorted(self._adapter_registry.items()):
            eng.register_adapter(t, w, scale=sc)
        eng.set_track_process(f"replica{len(self.replicas)}")
        eng.warmup()
        w1 = time.perf_counter()
        bs = eng.boot_stats or {}
        self._last_boot = {
            "warm": bool(bs.get("warm")), "parked": False,
            "boot_s": w1 - w0,
            "compile_s": float(bs.get("compile_s", 0.0)),
            "restored": int(bs.get("restored", 0)),
            "compiles": int(bs.get("compiles", 0))}
        if self.telemetry.enabled:
            self.telemetry.span(
                _SCALER_TRACK,
                f"replica_boot_"
                f"{'warm' if self._last_boot['warm'] else 'cold'}",
                w0, w1,
                args={"replica": len(self.replicas),
                      "t_virtual": t_now, **self._last_boot})
        r = Replica(len(self.replicas), eng)
        r.clock_s = t_now
        self.replicas.append(r)
        self._pins.append({})
        return r

    def register_adapter(self, tenant_id: int, weights, *,
                         scale: float = 1.0) -> None:
        """Register a tenant's LoRA adapter on EVERY replica (and on
        replicas the autoscaler activates later): the router may land
        the tenant anywhere, so the registry must be pool-uniform —
        residency (which replica holds the tenant's slab SLOT) is what
        adapter-affinity routing differentiates, not registration."""
        self._adapter_registry[int(tenant_id)] = (weights, float(scale))
        for r in self.replicas:
            r.engine.register_adapter(tenant_id, weights, scale=scale)

    def routable(self) -> List[Replica]:
        return [r for r in self.replicas if r.routable()]

    def compile_counts(self) -> Dict[str, Dict[str, int]]:
        return {f"replica{r.idx}": r.engine.compile_counts()
                for r in self.replicas}

    def assert_zero_recompiles(self) -> None:
        """The router gate: no replica compiled anything after ITS
        warmup (replicas added by the autoscaler snapshot at their own
        activation)."""
        for r in self.replicas:
            now = r.engine.compile_counts()
            assert now == r.warm_counts, (
                f"replica{r.idx} recompiled: {r.warm_counts} -> {now}")

    def check_drained(self) -> None:
        """Post-drain invariants: every pool clean, every page
        reclaimed (prefix-parked pages are refcount-0 reclaimable and
        count as free)."""
        for r in self.replicas:
            r.engine.cache.check_invariants()
            c = r.engine.cache_cfg
            free = r.engine.cache.free_pages
            assert free == c.usable_pages, (
                f"replica{r.idx} leaked pages: {free} free of "
                f"{c.usable_pages}")

    def close(self) -> None:
        server, self.metrics_server = self.metrics_server, None
        if server is not None:
            server.close()
        for r in self.replicas:
            r.session.close()
            r.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------- routing ------------------------------------------
    def route(self, prompt: Sequence[int], tenant: int = 0
              ) -> Tuple[Replica, dict]:
        """Pick the replica for one prompt. Affinity: longest
        chain-hash prefix match over every routable replica's page
        registry (extended through the router's pending pins), ties to
        the lowest replica id; tenant-sticky hash fallback on a total
        miss; load-aware spill off rung/occupancy pressure. Pure
        observation — the caller submits (and pins) via submit()."""
        live = self.routable()
        if not live:
            raise RuntimeError("no routable replicas")
        ps = live[0].engine.cache_cfg.page_size
        npages = max(0, (len(prompt) - 1) // ps)
        # a tenant is an ADAPTER tenant only if the pool registered
        # one; otherwise the id is a pure routing-affinity key and the
        # lane serves the base model (tenant_id=0)
        adapted = int(tenant) != 0 and int(tenant) in \
            self._adapter_registry
        # the probe keys carry the tenant's prefix salt — an adapted
        # tenant's pages hash on a disjoint chain (adapters.
        # tenant_prefix_salt), so the router's registry probe matches
        # exactly the pages admission would attach
        keys = prefix_page_keys(
            prompt, ps, npages,
            prev=tenant_prefix_salt(tenant) if adapted else b"") \
            if npages else []
        info = {"tenant": int(tenant), "adapted": adapted,
                "matched_tokens": 0,
                "affinity_hit": False, "host_hit": False,
                "adapter_affinity": False,
                "fallback": False, "spilled": False, "keys": keys}
        if self.policy == "round_robin":
            target = live[self._rr_next % len(live)]
            self._rr_next += 1
            return target, info
        best = None
        best_pages = 0
        for r in live:
            # the registry probe: one dict hit per page-aligned block
            k = len(r.engine.cache.match_prefix(keys))
            pins = self._pins[r.idx]
            while k < len(keys) and keys[k] in pins:
                k += 1
            if k > best_pages:
                best, best_pages = r, k
        if best is not None:
            target = best
            info["affinity_hit"] = True
            info["matched_tokens"] = best_pages * ps
        else:
            # adapter affinity, the tier between prefix affinity and
            # the blind hash: with no page match, a replica where the
            # tenant's adapter is already RESIDENT (slab loaded —
            # mapped or LRU-parked) skips the admission load stall.
            # Ties to the least-loaded such replica; the plain
            # tenant-sticky hash only when no replica holds it.
            resident = [r for r in live
                        if adapted
                        and r.engine.adapter_resident(tenant)]
            # host-tier affinity, the second tier below an HBM hit:
            # the SHARED store can reload the prefix into ANY
            # replica (priced DMA vs recompute at admission), so
            # land on the least-loaded one — preferring a replica
            # where the tenant's adapter is already resident
            host_pages = (self.host_tier.probe_chain(keys)
                          if self.host_tier is not None and keys
                          else 0)
            if host_pages > 0:
                pool = resident if resident else live
                target = min(pool, key=lambda x: (x.occupancy(),
                                                  x.queue_depth(),
                                                  x.idx))
                info["host_hit"] = True
                info["adapter_affinity"] = bool(resident)
                info["matched_tokens"] = host_pages * ps
            elif resident:
                target = min(resident, key=lambda x: (x.occupancy(),
                                                      x.queue_depth(),
                                                      x.idx))
                info["adapter_affinity"] = True
            else:
                target = live[_tenant_hash(tenant) % len(live)]
                info["fallback"] = True
        if len(live) > 1 and (target.rung() >= self.spill_rung
                              or target.occupancy()
                              >= self.spill_occupancy):
            # backpressure spill: queueing an affinity hit behind a
            # saturated pool costs more than a cold prefill elsewhere
            alt = min(live, key=lambda x: (x.occupancy(),
                                           x.queue_depth(), x.idx))
            if alt is not target \
                    and alt.occupancy() < target.occupancy():
                target = alt
                info["spilled"] = True
        return target, info

    def _pin(self, replica: Replica, keys: List[bytes]) -> None:
        pins = self._pins[replica.idx]
        for k in keys:
            pins[k] = pins.get(k, 0) + 1

    def _release_pins(self, tracked: dict) -> None:
        """Drop a request's affinity pins (terminal outcome or
        cancel): a pin held past its request would keep steering
        tenants at a replica that may never commit those pages."""
        if tracked.get("pins_released"):
            return
        tracked["pins_released"] = True
        pins = self._pins[tracked["replica"]]
        for k in tracked["keys"]:
            n = pins.get(k, 0) - 1
            if n <= 0:
                pins.pop(k, None)
            else:
                pins[k] = n

    def submit(self, tr: TrafficRequest, *,
               eos_token: Optional[int] = None) -> dict:
        """Route + submit one traffic request, returning its tracking
        record. The sampling stream keys to ``tr.stream_id``, so the
        emitted tokens are identical on ANY replica (and to a single
        engine serving the same stream ids)."""
        if tr.stream_id in self._inflight \
                or tr.stream_id in self._records:
            raise ValueError(
                f"stream id {tr.stream_id} already submitted")
        # trace context is minted HERE — the first tier that sees the
        # request — and rides the Request into whichever replica wins,
        # so the routing decision and every downstream engine span
        # share one causally-linked timeline 
        trace_id = next_trace_id()
        t_route0 = time.perf_counter()
        replica, info = self.route(tr.prompt, tenant=tr.tenant)
        eng = replica.engine
        sample = None
        if tr.temperature and float(tr.temperature) > 0.0:
            sample = eng._sample_params(
                tr.temperature, tr.top_k, self._sample_seed, 1,
                eng.topk_cap)[0]
        # an idle replica starts serving at the arrival instant, not
        # at whatever its clock last drained to (virtual mode only —
        # wall mode never reads clock_s, and stamping traffic-plan
        # times into it would corrupt a later virtual run's clocks)
        if self._clock == "virtual" and not replica.session.has_work():
            replica.clock_s = max(replica.clock_s, tr.t_arrival)
        req = replica.session.submit(
            tr.prompt, tr.max_new, eos_token=eos_token, sample=sample,
            stream_id=tr.stream_id, trace_id=trace_id,
            tenant_id=tr.tenant if info["adapted"] else 0)
        tracked = {
            "stream_id": tr.stream_id, "tenant": tr.tenant,
            "replica": replica.idx, "req": req,
            "trace_id": trace_id,
            "t_arrival": tr.t_arrival, "t_first": None,
            "t_finish": None, "tokens_emitted": 0,
            "cancel_after": tr.cancel_after_tokens,
            "cancel_sent": False, "sampled": tr.sampled,
            "affinity_hit": info["affinity_hit"],
            "host_hit": info["host_hit"],
            "adapter_affinity": info["adapter_affinity"],
            "spilled": info["spilled"], "fallback": info["fallback"],
            "matched_tokens": info["matched_tokens"],
            "keys": info["keys"], "pins_released": False,
        }
        self._pin(replica, info["keys"])
        self._inflight[tr.stream_id] = tracked
        replica.inflight.add(tr.stream_id)
        replica.assigned += 1
        self.stats["routed"] += 1
        m = self.metrics
        m.inc("router_requests_total", replica=str(replica.idx))
        if info["affinity_hit"]:
            self.stats["affinity_hits"] += 1
            m.inc("router_affinity_hits_total")
        if info["host_hit"]:
            self.stats["host_hits"] += 1
            m.inc("router_host_hits_total")
        if info["adapter_affinity"]:
            self.stats["adapter_affinity_hits"] += 1
            m.inc("router_adapter_affinity_hits_total")
        if info["fallback"]:
            self.stats["fallbacks"] += 1
            m.inc("router_fallback_total")
        if info["spilled"]:
            self.stats["spills"] += 1
            m.inc("router_spills_total")
        if self.telemetry.enabled:
            # the routing decision is a SPAN (wall time the router
            # spent matching/spilling, the "routing" component of
            # explain_request) with the trace id every downstream
            # engine span shares; the legacy "route" instant keeps its
            # one-line decision record
            self.telemetry.span(
                _ROUTER_TRACK, "routing", t_route0,
                time.perf_counter(),
                args={"trace": trace_id, "stream": tr.stream_id,
                      "replica": replica.idx})
            self.telemetry.instant(
                _ROUTER_TRACK, "route",
                args={"stream": tr.stream_id, "tenant": tr.tenant,
                      "trace": trace_id,
                      "replica": replica.idx,
                      "matched_tokens": info["matched_tokens"],
                      "affinity": info["affinity_hit"],
                      "spilled": info["spilled"],
                      "t_virtual": tr.t_arrival})
        return tracked

    def cancel(self, stream_id: int) -> bool:
        """Host-side cancel by stream id (a user abandoning
        mid-generation — or mid-QUEUE: a waiting request aborts at its
        replica's next chunk boundary). The affinity pin reclaims
        immediately — routing must stop steering the tenant at a
        replica that will never commit those pages."""
        tracked = self._inflight.get(stream_id)
        if tracked is None:
            return False
        replica = self.replicas[tracked["replica"]]
        ok = replica.engine.cancel(tracked["req"].rid)
        if ok:
            tracked["cancel_sent"] = True
            self.stats["cancels_sent"] += 1
            self.metrics.inc("router_cancels_total")
        self._release_pins(tracked)
        return ok

    # ---------------- virtual-clock pricing ----------------------------
    def _price(self, replica: Replica, ev: StepEvents) -> float:
        """Virtual seconds of one mixed step: the SAME cost-stack
        pricing the placement search and the drift calibrator use
        (engine._drift_predicted -> simulate_serve_step at the
        engine's fixed lane width, cached per context bucket), with
        JAX's deterministic analytic fallback when the cost stack
        cannot price the arch. Deterministic by construction — the
        whole virtual cluster replays at one seed."""
        eng = replica.engine
        ctx_b = pow2_bucket(max(1, ev.ctx_mean))
        pred = eng._drift_predicted(ctx_b)
        if pred is not None:
            return float(pred[0])
        return 1e-4 * (1.0 + eng.mixed_width / 512.0) \
            * (1.0 + ctx_b / 2048.0)

    def price_probe(self, ctx: int = 64) -> float:
        """The virtual step price at a typical context — what the
        bench derives SLO targets and arrival rates from, so the
        workload scales with the priced engine instead of hardcoding
        wall seconds."""
        ev = StepEvents()
        ev.ctx_mean = int(ctx)
        return self._price(self.replicas[0], ev)

    def _host_tier_block(self) -> Optional[dict]:
        """The pool-level host-tier block of last_stats: the SHARED
        store's lifetime report merged with the per-engine reload
        decision counters summed across replicas (each engine prices
        its own reloads; the store is one). Also corrects the
        registry: the per-replica serve_metrics folds counter_set the
        per-engine reload counters, so the last replica's value would
        otherwise shadow the rest — re-set the pool-wide sums."""
        if self.host_tier is None:
            return None
        host = dict(self.host_tier.report())
        for k in ("reload_events", "reload_pages", "spilled_pages",
                  "recompute_chosen"):
            host[k] = sum(
                int(r.engine._host_reload_stats.get(k, 0))
                for r in self.replicas)
        host["reload_priced_s"] = sum(
            float(r.engine._host_reload_stats.get(
                "reload_priced_s", 0.0))
            for r in self.replicas)
        m = self.metrics
        m.counter_set("serve_host_tier_reload_pages_total",
                      host["reload_pages"])
        m.counter_set("serve_host_tier_recompute_chosen_total",
                      host["recompute_chosen"])
        return host

    def _mesh_block(self) -> Optional[dict]:
        """The 2-D placement block of last_stats (serve_replicas=
        "auto"): the chosen (t, r) cell with its priced goodput, every
        rejected neighbor cell with ITS price, and the HBM-infeasible
        degrees — the chosen-vs-rejected discipline router_report
        renders. None on explicitly-sized pools."""
        p = self.mesh_placement
        if p is None:
            return None
        cells = {}
        for (t, r), cell in p.table.items():
            cells[f"{t}x{r}"] = {
                k: cell[k] for k in ("goodput_per_s", "tokens_per_s",
                                     "tpot_s", "ttft_s")}
        return {
            "tensor_parallel": p.tensor_parallel,
            "replicas": p.replicas,
            "tensor_axis_dims": list(p.tensor_axis_dims),
            "data_axis_dims": list(p.data_axis_dims),
            "goodput_per_s": p.goodput_per_s,
            "num_devices": p.num_devices,
            "table": cells,
            "infeasible": [dict(d) for d in p.infeasible],
        }

    # ---------------- the serving loop ---------------------------------
    def _finalize(self, tracked: dict, t_end: float,
                  slo_ttft_s: Optional[float],
                  slo_tpot_s: Optional[float]) -> None:
        req: Request = tracked["req"]
        sid = tracked["stream_id"]
        self._inflight.pop(sid, None)
        self.replicas[tracked["replica"]].inflight.discard(sid)
        self._release_pins(tracked)
        tokens = list(req.out_tokens)
        ttft = (tracked["t_first"] - tracked["t_arrival"]
                if tracked["t_first"] is not None else None)
        tpot = 0.0
        if tracked["t_first"] is not None and len(tokens) > 1:
            tpot = (t_end - tracked["t_first"]) / (len(tokens) - 1)
        completed = req.outcome == RequestOutcome.COMPLETED
        slo_ok = completed and ttft is not None \
            and (not slo_ttft_s or ttft <= slo_ttft_s) \
            and (not slo_tpot_s or tpot <= slo_tpot_s)
        self._records[sid] = {
            "stream_id": sid, "tenant": tracked["tenant"],
            "replica": tracked["replica"],
            "trace_id": tracked["trace_id"],
            "outcome": req.outcome, "tokens": tokens,
            "t_arrival": tracked["t_arrival"],
            "ttft_s": ttft, "tpot_s": tpot, "t_finish": t_end,
            "slo_ok": slo_ok, "sampled": tracked["sampled"],
            "affinity_hit": tracked["affinity_hit"],
            "host_hit": tracked["host_hit"],
            "adapter_affinity": tracked["adapter_affinity"],
            "spilled": tracked["spilled"],
            "fallback": tracked["fallback"],
            "matched_tokens": tracked["matched_tokens"],
            "cancelled_by_router": tracked["cancel_sent"],
        }
        self._req_refs[sid] = req   # explain_request / attribution
        self._w_done.append((t_end, tpot, len(tokens)))
        m = self.metrics
        # SLO error-budget accounting (utils/slo.py reads ONLY these
        # exported counters): every finalized request except a
        # router-sent cancel (a user abandon is not the tier's error)
        # enters the denominator; a violation is any counted request
        # that missed — a completed one past target, or one the tier
        # failed outright (rejected / deadline / failed), labeled by
        # which bound (or outcome) it burned
        if (slo_ttft_s or slo_tpot_s) \
                and not tracked["cancel_sent"] \
                and req.outcome != RequestOutcome.CANCELLED:
            m.inc("serve_slo_requests_total")
            if not slo_ok:
                m.inc("serve_slo_violations_total")
                if not completed:
                    m.inc("serve_slo_violations_total", slo="outcome")
                else:
                    if slo_ttft_s and (ttft is None
                                       or ttft > slo_ttft_s):
                        m.inc("serve_slo_violations_total", slo="ttft")
                    if slo_tpot_s and tpot > slo_tpot_s:
                        m.inc("serve_slo_violations_total", slo="tpot")
        if ttft is not None:
            m.observe(f"serve_router_ttft_{self._clock}_seconds",
                      ttft)
            self._w_first.append((tracked["t_first"], ttft))
        if tpot:
            m.observe(f"serve_router_tpot_{self._clock}_seconds",
                      tpot)
        m.inc("router_requests_finished_total", outcome=req.outcome)

    def _sweep_terminal(self, replica: Replica, t_end: float,
                        slo_ttft_s, slo_tpot_s) -> None:
        done = [sid for sid in replica.inflight
                if self._inflight[sid]["req"].outcome
                != RequestOutcome.PENDING]
        for sid in done:
            self._finalize(self._inflight[sid], t_end, slo_ttft_s,
                           slo_tpot_s)

    def _export_gauges(self, t_now: float) -> None:
        """Publish the autoscaler's decision inputs into the shared
        registry — per-replica occupancy/rung, pool occupancy mean,
        queue depth, and the windowed virtual TTFT/TPOT p99 + token
        demand. The autoscaler reads ONLY these."""
        m = self.metrics
        routable = self.routable()
        m.set("serve_pool_replicas_live", float(len(routable)))
        m.set("serve_pool_replicas_total", float(len(self.replicas)))
        m.set("serve_pool_boot_cost_s", self._next_boot_cost_s())
        occs = []
        for r in self.replicas:
            occ = r.occupancy() if r.live else 0.0
            m.set("serve_pool_occupancy", occ, replica=str(r.idx))
            m.set("serve_pool_rung",
                  float(r.rung()) if r.live else 0.0,
                  replica=str(r.idx))
            if r.routable():
                occs.append(occ)
        m.set("serve_pool_occupancy_mean",
              sum(occs) / len(occs) if occs else 0.0)
        m.set("serve_pool_queue_depth",
              float(sum(r.queue_depth() for r in self.replicas
                        if r.live)))
        w0 = t_now - self.window_s
        # full filter, not a sorted-head prune: first-token stamps land
        # in FINISH order and replica clocks interleave, so neither
        # deque is time-sorted — a head-only prune would let stale
        # samples behind an in-window head pollute the p99 gauges.
        # t_now only moves forward, so dropped entries never return.
        self._w_first = deque(x for x in self._w_first if x[0] >= w0)
        self._w_done = deque(x for x in self._w_done if x[0] >= w0)
        ttfts = sorted(v for _t, v in self._w_first)
        tpots = sorted(tp for _t, tp, _n in self._w_done if tp > 0)
        m.set("serve_pool_ttft_p99_window_s", pct(ttfts, 99))
        m.set("serve_pool_tpot_p99_window_s", pct(tpots, 99))
        toks = sum(n for _, _, n in self._w_done)
        m.set("serve_pool_decode_tokens_per_s_window",
              toks / self.window_s if self.window_s > 0 else 0.0)
        # cumulative SLO attainment over the exported error-budget
        # counters — the gauge tools/perf_report.py and slo_report
        # read (1.0 until any request enters the denominator)
        tot = m.counter("serve_slo_requests_total")
        viol = m.counter("serve_slo_violations_total")
        m.set("serve_pool_slo_attainment",
              (tot - viol) / tot if tot > 0 else 1.0)

    def _next_boot_cost_s(self) -> float:
        """Priced cost (seconds of capture) of the NEXT scale-up,
        exported as serve_pool_boot_cost_s: 0 when a parked warm
        replica exists; otherwise the measured capture seconds of the
        most recent cold boot."""
        if any(not r.live for r in self.replicas):
            return 0.0
        if self._last_boot and not self._last_boot.get("warm"):
            cs = float(self._last_boot.get("compile_s", 0.0))
            if cs > 0:
                return cs
        bs = self.replicas[0].engine.boot_stats or {}
        return float(bs.get("compile_s", 0.0))

    def _default_autoscaler(self) -> Autoscaler:
        """The serve_autoscale autoscaler: SLOs and ceiling from
        FFConfig, evaluation cadence and cooldown scaled off the priced
        step, per-replica capacity from the placement search's decode
        table (or the 2-D mesh table when the pool was searched)."""
        price = self.price_probe(64)
        eng = self.replicas[0].engine
        table = None
        mesh_table = None
        kw = {}
        if self.mesh_placement is not None:
            # the 2-D search already priced the (t, r) grid: target
            # pricing reads THAT table; the ceiling covers the searched
            # count
            mesh_table = self.mesh_placement.table
            table = self.mesh_placement.decode_by_degree
            kw["max_replicas"] = max(
                2 * self.mesh_placement.replicas,
                int(self.config.serve_autoscale_max))
        else:
            try:
                from ..search.serve_place import optimize_serve
                table = optimize_serve(
                    eng.serve_arch(), max(1, eng.tp),
                    config=self.config).decode_by_degree
            except Exception:
                pass  # unpriceable arch: pure SLO/occupancy triggers
        return Autoscaler.from_config(
            self.config, self.metrics, interval_s=20.0 * price,
            cooldown_s=40.0 * price, decode_table=table,
            mesh_table=mesh_table, tensor_parallel=max(1, eng.tp),
            decode_lanes=int(self.config.serve_max_seqs), **kw)

    def _maybe_park(self, r: Replica) -> None:
        """A draining replica parks (warm, routable again on the next
        scale-up) the moment its session empties — checked after
        every step AND at run end, since the last request can finish
        on a dispatched step that is never followed by an empty
        one."""
        if r.draining and not r.session.has_work():
            r.draining = False
            r.live = False

    def _apply_scale(self, decision: Optional[dict], t_now: float
                     ) -> None:
        if decision is None:
            return
        tel = self.telemetry
        w0 = time.perf_counter()
        if decision["direction"] == "up":
            r = self._activate_replica(t_now)
            self.stats["scale_ups"] += 1
        else:
            candidates = [x for x in self.routable()]
            # retire the least-loaded replica (its inflight work
            # drains before it parks)
            r = min(candidates, key=lambda x: (x.occupancy(),
                                               x.queue_depth(),
                                               len(x.inflight),
                                               -x.idx))
            r.draining = True
            # an ALREADY-idle replica parks right here — it will never
            # be stepped again, and a stranded live+draining replica
            # would make the next scale-up build a cold engine while a
            # warm one sits unroutable
            self._maybe_park(r)
            self.stats["scale_downs"] += 1
        event = {**{k: v for k, v in decision.items()},
                 "replica": r.idx}
        self.scale_events.append(event)
        self.metrics.inc("serve_autoscale_events_total",
                         direction=decision["direction"])
        if tel.enabled:
            # the scale event is a SPAN: real wall time spent applying
            # it, virtual decision time in the args. A scale-up's boot
            # cost is carried by the adjacent `replica_boot` span
            # (_activate_replica): warm boots — a parked replica or a
            # --program-cache-dir deserialization — are hairline,
            # and a cold boot's width IS the measured compile storm
            # the autoscaler priced into the decision as `boot_s`
            tel.span(_SCALER_TRACK,
                     f"scale_{decision['direction']}", w0,
                     time.perf_counter(),
                     args={"replica": r.idx, "t_virtual": t_now,
                           "reason": decision["reason"],
                           "live": len(self.routable()),
                           "boot": self._last_boot
                           if decision["direction"] == "up" else None,
                           "priced_target":
                               decision.get("priced_target")})

    def _default_slo_monitor(self, slo_ttft_s, slo_tpot_s
                             ) -> "object":
        """The auto-armed burn-rate monitor (utils/slo.py): windows
        and cadence scaled off the priced virtual step exactly like
        the autoscaler's, error budget from FFConfig.slo_error_budget
        — a deterministic function of the exported counters, so its
        alert transitions replay at one seed."""
        from ..utils.slo import SLOBurnMonitor
        price = self.price_probe(64)
        interval = 20.0 * price
        return SLOBurnMonitor(
            self.metrics,
            error_budget=float(getattr(self.config, "slo_error_budget",
                                       0.01)),
            fast_window_s=5.0 * interval,
            slow_window_s=20.0 * interval,
            interval_s=interval,
            telemetry=self.telemetry,
            slo={"ttft_s": slo_ttft_s or 0.0,
                 "tpot_s": slo_tpot_s or 0.0})

    def run(self, traffic: Sequence[TrafficRequest], *,
            slo_ttft_s: Optional[float] = None,
            slo_tpot_s: Optional[float] = None,
            eos_token: Optional[int] = None,
            autoscaler: Optional[Autoscaler] = None,
            slo_monitor=None,
            sample_seed: int = 0, on_step=None,
            wall_clock: Optional[bool] = None,
            wall_threads: bool = True,
            time_scale: float = 1.0,
            dwell_s: float = 0.0) -> dict:
        """Serve a timed traffic stream and return the
        goodput-under-SLO accounting (also stashed on ``last_stats``).

        Two clocks. The VIRTUAL clock prices each step (``_price``) and
        replays deterministically at one seed — authoritative for
        search A/Bs and autoscaler replay. ``wall_clock=True`` (or
        ``serve_wall_clock``) serves the SAME traffic in real time:
        arrivals pace on the wall clock (``tr.t_arrival * time_scale``
        seconds after run start) and each replica runs its session
        step loop on its own worker thread, on its engine's own CUDA
        stream (``wall_threads=False`` steps them round-robin from one
        thread — the A/B baseline), so goodput under SLO is a measured
        wall number. Tensor-parallel replicas (t > 1) step round-robin
        from one thread on every rank, in lockstep on rank 0's clock,
        whatever ``wall_threads`` says (:meth:`_run_lockstep`). TOKENS
        are identical across all modes: sampling
        keys on stream ids, never on the clock. ``dwell_s`` holds each
        dispatched step for at least that many wall seconds — a
        stand-in for device time on a host whose "device" is its own
        CPU; on the card the device's own time is the dwell (run at
        0).

        Virtual event loop: the next event is the earlier of (the next
        arrival, the busy replica with the smallest clock). Arrivals
        route + submit (an idle target's clock jumps to the arrival
        instant); a replica step advances its clock by the priced
        step time and stamps first-token/finish times at the step's
        END. The autoscaler (when given) ticks every ``interval_s``
        of virtual time off the freshly exported gauges.
        ``on_step(replica, ev)`` observes every replica step (the
        chaos tests' cluster-wide invariant hook; called from the
        router thread in every mode)."""
        if slo_ttft_s is None:
            ms = float(getattr(self.config, "slo_ttft_ms", 0.0))
            slo_ttft_s = ms / 1e3 if ms > 0 else None
        if slo_tpot_s is None:
            ms = float(getattr(self.config, "slo_tpot_ms", 0.0))
            slo_tpot_s = ms / 1e3 if ms > 0 else None
        if wall_clock is None:
            wall_clock = bool(self.config.serve_wall_clock)
        if wall_clock:
            if autoscaler is not None or bool(
                    getattr(self.config, "serve_autoscale", False)):
                raise ValueError(
                    "the autoscaler replays on the virtual clock "
                    "only (its decisions must be reproducible at one "
                    "seed) — run wall-clock without serve_autoscale")
            return self._run_wall(
                traffic, slo_ttft_s=slo_ttft_s,
                slo_tpot_s=slo_tpot_s, eos_token=eos_token,
                slo_monitor=slo_monitor, sample_seed=sample_seed,
                on_step=on_step, threaded=bool(wall_threads),
                time_scale=float(time_scale), dwell_s=float(dwell_s))
        self._clock = "virtual"
        if autoscaler is None and bool(getattr(self.config,
                                               "serve_autoscale",
                                               False)):
            # --autoscale: arm the config-built autoscaler (SLOs and
            # ceiling from the flags, cadence off the priced step,
            # capacity off the placement search's decode table)
            autoscaler = self._default_autoscaler()
        # slo_monitor=False disarms explicitly (the call-level spelling
        # of FFConfig.slo_monitor=False); None = auto-arm with the SLOs
        arm_default = slo_monitor is None
        if not slo_monitor:
            slo_monitor = None
        if arm_default and (slo_ttft_s or slo_tpot_s) \
                and bool(getattr(self.config, "slo_monitor", True)):
            # burn-rate monitoring comes with the SLOs: a tier with
            # latency targets but no budget alarm is flying blind
            slo_monitor = self._default_slo_monitor(slo_ttft_s,
                                                    slo_tpot_s)
        self._sample_seed = int(sample_seed)
        self._records = {}
        self._req_refs = {}
        self._w_first.clear()
        self._w_done.clear()
        # per-run accounting: self.stats/scale_events stay LIFETIME
        # (the DisaggCluster idiom) and last_stats reports this run's
        # DELTA/slice; round-robin placement restarts so a reused
        # pool reproduces a fresh pool's routing exactly
        stats0 = dict(self.stats)
        events0 = len(self.scale_events)
        self._rr_next = 0
        # fresh per-run sessions on drained replicas: stats_dict (and
        # with it the end-of-run registry fold) must cover THIS run —
        # re-folding a session-lifetime dict would double-count every
        # earlier run's requests. Engine state (prefix cache, compiled
        # programs) persists; only the scheduler/stats reset.
        for r in self.replicas:
            if r.session.reqs and not r.session.has_work():
                r.session.close()
                r.session = r.engine.start_session()
        n_start = len(self.routable())
        arrivals = sorted(traffic,
                          key=lambda r: (r.t_arrival, r.stream_id))
        t0_virtual = arrivals[0].t_arrival if arrivals else 0.0
        if autoscaler is not None:
            self.window_s = max(self.window_s,
                                2.0 * autoscaler.interval_s)
            self._next_eval = t0_virtual + autoscaler.interval_s
        next_slo = (t0_virtual + slo_monitor.interval_s
                    if slo_monitor is not None else None)
        i = 0
        t_virtual = t0_virtual
        while True:
            busy = [r for r in self.replicas if r.has_work()]
            nxt = arrivals[i] if i < len(arrivals) else None
            if not busy and nxt is None:
                break
            step_r = min(busy, key=lambda r: (r.clock_s, r.idx)) \
                if busy else None
            if nxt is not None and (step_r is None
                                    or nxt.t_arrival
                                    <= step_r.clock_s):
                t_virtual = max(t_virtual, nxt.t_arrival)
                self.submit(nxt, eos_token=eos_token)
                i += 1
            else:
                r = step_r
                try:
                    ev = r.session.step()
                except Exception:
                    # contain exactly as generate() would: fail the
                    # in-flight requests, keep the REST of the pool
                    # serving, reopen the replica's session
                    r.engine._fail_inflight(r.session.sched,
                                            r.session.reqs)
                    r.session.close()
                    self._sweep_terminal(r, r.clock_s, slo_ttft_s,
                                         slo_tpot_s)
                    r.session = r.engine.start_session()
                    continue
                if ev is None:
                    self._sweep_terminal(r, r.clock_s, slo_ttft_s,
                                         slo_tpot_s)
                    self._maybe_park(r)
                    continue
                if not ev.dispatched:
                    r._plan_only += 1
                    if r._plan_only > _MAX_PLAN_ONLY:
                        raise RuntimeError(
                            f"replica{r.idx} re-planned "
                            f"{_MAX_PLAN_ONLY} steps without "
                            f"dispatching — scheduler wedged")
                    self._sweep_terminal(r, r.clock_s, slo_ttft_s,
                                         slo_tpot_s)
                    continue
                r._plan_only = 0
                # the priced host-tier DMA rides the same virtual
                # clock the step does: a reload is not free, it is
                # host_transfer seconds the admission already judged
                # cheaper than recompute (engine._host_reload)
                price = self._price(r, ev) + ev.host_reload_s
                r.clock_s += price
                r.busy_s += price
                r.steps += 1
                r.peak_occupancy = max(r.peak_occupancy,
                                       r.occupancy())
                t_end = r.clock_s
                t_virtual = max(t_virtual, t_end)
                for req, n in ev.emitted:
                    tracked = self._inflight.get(req.stream_id)
                    if tracked is None:
                        continue
                    if tracked["tokens_emitted"] == 0:
                        tracked["t_first"] = t_end
                    tracked["tokens_emitted"] += n
                    r.tokens += n
                    ca = tracked["cancel_after"]
                    if ca is not None and not tracked["cancel_sent"] \
                            and tracked["tokens_emitted"] >= ca:
                        # mid-generation abandon: the ONE cancel path
                        # (aborts at the next chunk boundary, pin
                        # reclaims now)
                        self.cancel(req.stream_id)
                self._sweep_terminal(r, t_end, slo_ttft_s, slo_tpot_s)
                self._maybe_park(r)
                if on_step is not None:
                    on_step(r, ev)
            if autoscaler is not None:
                while t_virtual >= self._next_eval:
                    self._export_gauges(self._next_eval)
                    self._apply_scale(
                        autoscaler.evaluate(self._next_eval),
                        self._next_eval)
                    self._next_eval += autoscaler.interval_s
            if slo_monitor is not None:
                # the burn monitor ticks on the same virtual clock the
                # autoscaler does — its counters are kept current by
                # _finalize, so each tick is a pure function of the
                # exported registry + monitor state (replayable)
                while t_virtual >= next_slo:
                    slo_monitor.observe(next_slo)
                    next_slo += slo_monitor.interval_s
        # anything still tracked (a cancel that raced completion)
        for sid in list(self._inflight):
            self._finalize(self._inflight[sid], t_virtual,
                           slo_ttft_s, slo_tpot_s)
        for r in self.replicas:
            self._maybe_park(r)
        self._export_gauges(t_virtual)
        if slo_monitor is not None:
            # one closing tick + episode close, so an alert burning at
            # drain still transitions (and its span gets an end)
            slo_monitor.observe(t_virtual)
            slo_monitor.finish(t_virtual)
        records = [self._records[sid]
                   for sid in sorted(self._records)]
        makespan = max(1e-12, t_virtual - t0_virtual)
        ok = sum(1 for rec in records if rec["slo_ok"])
        completed = sum(1 for rec in records
                        if rec["outcome"] == RequestOutcome.COMPLETED)
        # fold each replica's session stats into the registry — the
        # per-replica LABELED split (the serve_metrics replica= fold,
        # same no-double-counting rule as disagg's roles) plus the
        # unlabeled pool aggregate
        for r in self.replicas:
            st = r.session.stats_dict()
            serve_metrics(st, registry=self.metrics)
            serve_metrics(st, registry=self.metrics,
                          replica=str(r.idx))
        self.last_stats = {
            "mode": "router",
            "policy": self.policy,
            "autoscaled": autoscaler is not None,
            "replicas_start": n_start,
            "replicas_end": len(self.routable()),
            "replicas_total": len(self.replicas),
            "requests": records,
            "goodput_per_s": ok / makespan,
            "slo_attainment": ok / len(records) if records else 0.0,
            "slo_ttft_s": slo_ttft_s, "slo_tpot_s": slo_tpot_s,
            "makespan_s": makespan,
            "completed": completed,
            "slo_ok": ok,
            "cancelled": sum(
                1 for rec in records
                if rec["outcome"] == RequestOutcome.CANCELLED),
            "tokens_total": sum(len(rec["tokens"])
                                for rec in records),
            "routing": {k: self.stats[k] - stats0[k]
                        for k in self.stats},
            "host_tier": self._host_tier_block(),
            "mesh_placement": self._mesh_block(),
            "scale_events": list(self.scale_events[events0:]),
            "per_replica": [
                {"replica": r.idx, "live": r.live,
                 "assigned": r.assigned, "steps": r.steps,
                 "tokens": r.tokens,
                 "busy_virtual_s": r.busy_s,
                 "peak_occupancy": r.peak_occupancy}
                for r in self.replicas],
            "slo_attainment_budget": self.metrics.gauge(
                "serve_pool_slo_attainment", 1.0),
            "slo_alerts": (list(slo_monitor.events)
                           if slo_monitor is not None else []),
        }
        if self.telemetry.enabled:
            # pool-level aggregate latency attribution: every finished
            # request's span fold lands in the shared registry
            # (serve_latency_attribution_* series) and the
            # per-component WALL totals ride along in last_stats
            self.last_stats["attribution"] = self.fold_attribution()
        return self.last_stats

    # ---------------- wall-clock serving --------------------------------
    def _wall_apply(self, r: Replica, ev, t_end: float, busy: float,
                    slo_ttft_s, slo_tpot_s, on_step) -> None:
        """Apply one replica step's outcome to the pool's tracking
        state. Wall mode's single mutation point for router state:
        workers only step sessions and report here, so first-token
        stamps, cancels, finalization, and ``on_step`` all happen on
        the router thread — same ordering discipline as the virtual
        loop, just fed from a queue."""
        if ev is None:
            self._sweep_terminal(r, t_end, slo_ttft_s, slo_tpot_s)
            self._maybe_park(r)
            return
        if not ev.dispatched:
            r._plan_only += 1
            if r._plan_only > _MAX_PLAN_ONLY:
                raise RuntimeError(
                    f"replica{r.idx} re-planned {_MAX_PLAN_ONLY} "
                    f"steps without dispatching — scheduler wedged")
            self._sweep_terminal(r, t_end, slo_ttft_s, slo_tpot_s)
            return
        r._plan_only = 0
        r.busy_wall_s += busy
        r.steps += 1
        r.peak_occupancy = max(r.peak_occupancy, r.occupancy())
        for req, n in ev.emitted:
            tracked = self._inflight.get(req.stream_id)
            if tracked is None:
                continue
            if tracked["tokens_emitted"] == 0:
                tracked["t_first"] = t_end
            tracked["tokens_emitted"] += n
            r.tokens += n
            ca = tracked["cancel_after"]
            if ca is not None and not tracked["cancel_sent"] \
                    and tracked["tokens_emitted"] >= ca:
                # engine.cancel is thread-safe by contract (the worker
                # may be mid-step); the abort lands at the request's
                # next chunk boundary exactly as in virtual mode
                self.cancel(req.stream_id)
        self._sweep_terminal(r, t_end, slo_ttft_s, slo_tpot_s)
        self._maybe_park(r)
        if on_step is not None:
            on_step(r, ev)

    def _wall_step(self, r: Replica, w_start: float, dwell_s: float):
        """One locked session step on the replica engine's own CUDA
        stream (so replicas stepping on separate threads overlap on the
        card instead of serializing on the default stream), then the
        dwell floor; returns ``(kind, ev, t_end, busy_s)``. The dwell
        sleep happens OUTSIDE the lock: it models time the host is
        blocked on the device, during which the router may submit into
        this replica."""
        t0 = time.perf_counter()
        with r.lock, r.engine.on_stream():
            try:
                ev = r.session.step()
            except LockstepError:
                # the ranks of a t > 1 replica disagree: every rank
                # raises at the same check, so the pool stops on all
                raise
            except Exception:
                # contain exactly as the virtual loop: fail the
                # in-flight requests, reopen the session, keep the
                # rest of the pool serving
                r.engine._fail_inflight(r.session.sched,
                                        r.session.reqs)
                r.session.close()
                r.session = r.engine.start_session()
                return ("fail", None,
                        time.perf_counter() - w_start, 0.0)
        elapsed = time.perf_counter() - t0
        if ev is not None and ev.dispatched and dwell_s > elapsed:
            time.sleep(dwell_s - elapsed)
            elapsed = dwell_s
        return ("step", ev, time.perf_counter() - w_start, elapsed)

    def _run_wall(self, traffic: Sequence[TrafficRequest], *,
                  slo_ttft_s, slo_tpot_s, eos_token, slo_monitor,
                  sample_seed, on_step, threaded: bool,
                  time_scale: float, dwell_s: float) -> dict:
        """Serve the traffic stream in real time. Arrivals pace on the wall clock —
        request i submits ``(t_arrival - t0) * time_scale`` wall
        seconds after run start — and timestamps (t_arrival, t_first,
        t_finish) are run-relative wall seconds on ONE clock, so
        ``explain_request`` still sums exactly to measured latency.

        ``threaded=True``: each replica's session step loop runs on
        its own worker thread; the worker holds ``replica.lock``
        across ``session.step()`` (the router thread holds it across
        ``session.submit()``) and reports completed steps into a
        queue the router thread drains — all router state mutates on
        the router thread. ``threaded=False`` steps busy replicas
        round-robin from the router thread: the A/B baseline. A pool
        of tensor-parallel replicas runs :meth:`_run_lockstep` in
        either case.

        No autoscaler here (it replays on the virtual clock), and no
        auto-armed SLO monitor — pass one explicitly to tick it on
        wall time. Tokens are identical to the virtual run at the
        same seed: sampling keys on stream ids, never on the
        clock."""
        slo_monitor = slo_monitor or None
        self._sample_seed = int(sample_seed)
        self._records = {}
        self._req_refs = {}
        self._w_first.clear()
        self._w_done.clear()
        stats0 = dict(self.stats)
        events0 = len(self.scale_events)
        self._rr_next = 0
        for r in self.replicas:
            if r.session.reqs and not r.session.has_work():
                r.session.close()
                r.session = r.engine.start_session()
        n_start = len(self.routable())
        arrivals = sorted(traffic,
                          key=lambda r: (r.t_arrival, r.stream_id))
        t0_virtual = arrivals[0].t_arrival if arrivals else 0.0
        sched = [(tr.t_arrival - t0_virtual) * time_scale
                 for tr in arrivals]
        self._clock = "wall"
        lockstep = None
        if any(r.engine.tp > 1 for r in self.replicas):
            from ..parallel.mesh import TENSOR
            lead = self.replicas[0].engine
            lockstep = Lockstep(lead.bm, TENSOR)
            threaded = False
            guards = [lockstep] + [r.engine._lockstep
                                   for r in self.replicas]
            calls0 = [(g.calls, g.wall_s) for g in guards]
        done_q: "queue.Queue" = queue.Queue()
        stop = threading.Event()
        wakes = [threading.Event() for _ in self.replicas]
        workers: List[threading.Thread] = []
        w_start = time.perf_counter()

        def _worker(r: Replica, wake: threading.Event) -> None:
            while not stop.is_set():
                if not r.has_work():
                    wake.wait(0.005)
                    wake.clear()
                    continue
                kind, ev, t_end, busy = self._wall_step(
                    r, w_start, dwell_s)
                done_q.put((kind, r.idx, ev, t_end, busy))

        t_final = None
        try:
            if lockstep is not None:
                t_final = self._run_lockstep(
                    lockstep, arrivals, sched, w_start,
                    slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
                    eos_token=eos_token, slo_monitor=slo_monitor,
                    on_step=on_step, dwell_s=dwell_s)
            else:
                if threaded:
                    for r, wake in zip(self.replicas, wakes):
                        t = threading.Thread(
                            target=_worker, args=(r, wake),
                            name=f"replica{r.idx}-step", daemon=True)
                        t.start()
                        workers.append(t)
                next_slo = (slo_monitor.interval_s
                            if slo_monitor is not None else None)
                i = 0
                rr = 0
                t_now = 0.0
                last_progress = time.perf_counter()
                while True:
                    t_now = time.perf_counter() - w_start
                    while i < len(arrivals) and sched[i] <= t_now + 1e-9:
                        tr = arrivals[i]
                        # submit holds EVERY replica lock (idx order):
                        # route() reads all replicas' queue/cache state
                        # and session.submit mutates the winner — both
                        # must not interleave with a worker's step
                        for r in self.replicas:
                            r.lock.acquire()
                        try:
                            tracked = self.submit(tr, eos_token=eos_token)
                        finally:
                            for r in reversed(self.replicas):
                                r.lock.release()
                        # SLOs measure from the SCHEDULED wall arrival —
                        # router lag between the pacer and submit() is
                        # queueing delay the tier must answer for
                        tracked["t_arrival"] = sched[i]
                        if threaded:
                            wakes[tracked["replica"]].set()
                        i += 1
                        last_progress = time.perf_counter()
                    if i >= len(arrivals) and not self._inflight:
                        break
                    if threaded:
                        timeout = 0.05 if i >= len(arrivals) else \
                            min(0.05, max(0.0, sched[i] - t_now))
                        try:
                            item = done_q.get(timeout=timeout) \
                                if timeout > 0 else done_q.get_nowait()
                        except queue.Empty:
                            if i >= len(arrivals) \
                                    and not any(r.has_work()
                                                for r in self.replicas):
                                break  # drained: a raced cancel's record
                            if time.perf_counter() - last_progress > 60.0:
                                raise RuntimeError(
                                    "wall-clock pool made no progress "
                                    "for 60s with work pending")
                            continue
                        while item is not None:
                            kind, idx, ev, t_end, busy = item
                            r = self.replicas[idx]
                            if kind == "fail":
                                self._sweep_terminal(r, t_end, slo_ttft_s,
                                                     slo_tpot_s)
                            else:
                                self._wall_apply(r, ev, t_end, busy,
                                                 slo_ttft_s, slo_tpot_s,
                                                 on_step)
                            last_progress = time.perf_counter()
                            try:
                                item = done_q.get_nowait()
                            except queue.Empty:
                                item = None
                    else:
                        busy_rs = [r for r in self.replicas
                                   if r.has_work()]
                        if not busy_rs:
                            if i < len(arrivals):
                                time.sleep(
                                    min(0.05,
                                        max(0.0, sched[i] - t_now)))
                                continue
                            break  # drained: a raced cancel's record
                        r = busy_rs[rr % len(busy_rs)]
                        rr += 1
                        kind, ev, t_end, busy = self._wall_step(
                            r, w_start, dwell_s)
                        if kind == "fail":
                            self._sweep_terminal(r, t_end, slo_ttft_s,
                                                 slo_tpot_s)
                        else:
                            self._wall_apply(r, ev, t_end, busy,
                                             slo_ttft_s, slo_tpot_s,
                                             on_step)
                        last_progress = time.perf_counter()
                    if slo_monitor is not None:
                        t_now = time.perf_counter() - w_start
                        while t_now >= next_slo:
                            slo_monitor.observe(next_slo)
                            next_slo += slo_monitor.interval_s
        finally:
            stop.set()
            for wake in wakes:
                wake.set()
            for t in workers:
                t.join(timeout=5.0)
            self._clock = "virtual"
        if t_final is None:
            t_final = time.perf_counter() - w_start
        # drain-time finalization still belongs to the wall run (the
        # finally above restored the label for the exception paths)
        self._clock = "wall"
        for sid in list(self._inflight):
            self._finalize(self._inflight[sid], t_final, slo_ttft_s,
                           slo_tpot_s)
        for r in self.replicas:
            self._maybe_park(r)
        self._export_gauges(t_final)
        self._clock = "virtual"
        if slo_monitor is not None:
            slo_monitor.observe(t_final)
            slo_monitor.finish(t_final)
        records = [self._records[sid]
                   for sid in sorted(self._records)]
        makespan = max(1e-12, t_final)
        ok = sum(1 for rec in records if rec["slo_ok"])
        completed = sum(1 for rec in records
                        if rec["outcome"] == RequestOutcome.COMPLETED)
        for r in self.replicas:
            st = r.session.stats_dict()
            serve_metrics(st, registry=self.metrics)
            serve_metrics(st, registry=self.metrics,
                          replica=str(r.idx))
        self.last_stats = {
            "mode": "router",
            "clock": "wall",
            "wall_threads": threaded,
            "lockstep": lockstep is not None,
            "time_scale": time_scale,
            "dwell_s": dwell_s,
            "policy": self.policy,
            "autoscaled": False,
            "replicas_start": n_start,
            "replicas_end": len(self.routable()),
            "replicas_total": len(self.replicas),
            "requests": records,
            "goodput_per_s": ok / makespan,
            "slo_attainment": ok / len(records) if records else 0.0,
            "slo_ttft_s": slo_ttft_s, "slo_tpot_s": slo_tpot_s,
            "makespan_s": makespan,
            "completed": completed,
            "slo_ok": ok,
            "cancelled": sum(
                1 for rec in records
                if rec["outcome"] == RequestOutcome.CANCELLED),
            "tokens_total": sum(len(rec["tokens"])
                                for rec in records),
            "routing": {k: self.stats[k] - stats0[k]
                        for k in self.stats},
            "host_tier": self._host_tier_block(),
            "mesh_placement": self._mesh_block(),
            "scale_events": list(self.scale_events[events0:]),
            "per_replica": [
                {"replica": r.idx, "live": r.live,
                 "assigned": r.assigned, "steps": r.steps,
                 "tokens": r.tokens,
                 "busy_virtual_s": r.busy_s,
                 "busy_wall_s": r.busy_wall_s,
                 "peak_occupancy": r.peak_occupancy}
                for r in self.replicas],
            "slo_attainment_budget": self.metrics.gauge(
                "serve_pool_slo_attainment", 1.0),
            "slo_alerts": (list(slo_monitor.events)
                           if slo_monitor is not None else []),
        }
        if lockstep is not None:
            # the pool's ticks and every lockstep call of the run (the
            # pool's leads, the engines' sweeps and lane checks) with
            # their wall seconds, the wait for the other ranks included
            self.last_stats["lockstep_ticks"] = lockstep.checks
            self.last_stats["lockstep_calls"] = sum(
                g.calls - c for g, (c, _) in zip(guards, calls0))
            self.last_stats["lockstep_wall_s"] = sum(
                g.wall_s - w for g, (_, w) in zip(guards, calls0))
        if self.telemetry.enabled:
            self.last_stats["attribution"] = self.fold_attribution()
        return self.last_stats

    def _lockstep_state(self, i: int, pending) -> int:
        """A digest of the pool's host state at a lockstep tick: the
        arrivals submitted, the replica whose step awaits its stamp,
        every replica's counters and every tracked request's progress
        — what two ranks given the same decisions hold alike."""
        rows = [(i, -1 if pending is None else pending[0].idx,
                 len(self._inflight), len(self._records), 0)]
        rows += [(r.idx, int(r.has_work()), r.steps, r.tokens,
                  len(r.inflight)) for r in self.replicas]
        rows += [(sid, t["replica"], t["tokens_emitted"],
                  int(t["cancel_sent"]), len(t["req"].out_tokens))
                 for sid, t in sorted(self._inflight.items())]
        return digest(np.array(rows, np.int64))

    def _run_lockstep(self, lockstep, arrivals, sched, w_start: float, *,
                      slo_ttft_s, slo_tpot_s, eos_token, slo_monitor,
                      on_step, dwell_s: float) -> float:
        """The wall loop of tensor-parallel replicas: every rank runs
        the whole pool, and the collectives of a replica's sharded step
        match only when every rank submits, routes and steps alike. So
        one thread a rank steps the busy replicas round-robin, and at
        each tick rank 0's decision (``Lockstep.lead``) rules every
        rank: the arrivals its clock finds due, the replica to step,
        the end stamp of the last step (stamped on rank 0's clock, and
        applied a tick late on every rank) and the tick's time, which
        the SLO monitor ticks on. A rank that paced arrivals or stepped
        a replica on its own holds other host state, and the next
        tick's digest raises ``LockstepError`` on every rank; cancels
        and deadline aborts ride the engines' own ``Lockstep.exchange``.
        Only rank 0 sleeps while nothing is due; the others wait in the
        next tick's gather. Returns the run's end on rank 0's clock."""
        from ..parallel.mesh import TENSOR
        leads = self.replicas[0].engine.bm.coord(TENSOR) == 0
        next_slo = (slo_monitor.interval_s
                    if slo_monitor is not None else None)
        i = 0
        rr = 0
        pending = None      # (replica, kind, ev, busy) of the last step
        t_stamp = 0.0       # this rank's end stamp of that step
        while True:
            state = self._lockstep_state(i, pending)
            t_now = time.perf_counter() - w_start
            due = 0
            while i + due < len(arrivals) \
                    and sched[i + due] <= t_now + 1e-9:
                due += 1
            busy = [r.idx for r in self.replicas if r.has_work()]
            pick = busy[rr % len(busy)] if busy else -1
            stop = pending is None and i >= len(arrivals) and not busy
            t_prev, due, pick, stop, t_now = lockstep.lead(
                "pool.tick", state,
                (t_stamp, due, pick, float(stop), t_now))
            due, pick = int(due), int(pick)
            if pending is not None:
                r, kind, ev, busy_s = pending
                pending = None
                if kind == "fail":
                    self._sweep_terminal(r, t_prev, slo_ttft_s,
                                         slo_tpot_s)
                else:
                    self._wall_apply(r, ev, t_prev, busy_s, slo_ttft_s,
                                     slo_tpot_s, on_step)
            if stop:
                return t_now
            for tr in arrivals[i:i + due]:
                tracked = self.submit(tr, eos_token=eos_token)
                tracked["t_arrival"] = sched[i]
                i += 1
            if slo_monitor is not None:
                while t_now >= next_slo:
                    slo_monitor.observe(next_slo)
                    next_slo += slo_monitor.interval_s
            if pick >= 0:
                r = self.replicas[pick]
                rr += 1
                kind, ev, t_stamp, busy_s = self._wall_step(
                    r, w_start, dwell_s)
                pending = (r, kind, ev, busy_s)
            elif leads and due == 0 and i < len(arrivals):
                time.sleep(min(0.05, max(0.0, sched[i] - t_now)))

    # ---------------- per-request observability -------------------------
    def explain_request(self, stream_id: int) -> dict:
        """Cross-engine latency attribution for one routed request of
        the last run, by stream id : the trace
        id minted at submit ties the router's routing span, the
        replica's queue_wait, its prefill/decode chunk spans and any
        preempt/retry stalls into one additive WALL-clock breakdown
        summing to the request's measured wall latency. (The virtual-
        clock TTFT/TPOT in last_stats price the simulated cluster;
        this explains where the real host/device time went.)"""
        if not self.telemetry.enabled:
            raise RuntimeError(
                "explain_request needs telemetry (pass telemetry= or "
                "set --telemetry/--trace-out)")
        req = self._req_refs.get(stream_id)
        if req is None:
            raise KeyError(
                f"stream id {stream_id} has no finalized request in "
                f"the last run")
        if not req.t_finish:
            raise ValueError(
                f"stream {stream_id} never terminated (outcome "
                f"{req.outcome!r})")
        out = self.telemetry.explain_request(
            req.trace_id, req.t_submit, req.t_finish)
        rec = self._records.get(stream_id) or {}
        out.update(stream_id=stream_id, outcome=req.outcome,
                   replica=rec.get("replica"),
                   tokens=len(req.out_tokens))
        return out

    def fold_attribution(self, registry=None) -> dict:
        """Fold every terminated request of the last run into
        `registry` (default: the pool registry) — the pool-level
        aggregate `serve_latency_attribution_*` series. Returns the
        per-component second totals."""
        m = registry if registry is not None else self.metrics
        totals = {c: 0.0 for c in REQUEST_COMPONENTS}
        if not self.telemetry.enabled:
            return totals
        for sid in sorted(self._req_refs):
            req = self._req_refs[sid]
            if not req.t_finish:
                continue
            b = self.telemetry.explain_request(
                req.trace_id, req.t_submit, req.t_finish)
            fold_attribution(b, m)
            for c, v in b["components"].items():
                totals[c] += v
        return totals

    def dump_postmortem(self, path: Optional[str] = None,
                        reason: str = "manual",
                        detail: Optional[dict] = None) -> str:
        """Pool flight-recorder dump: the lead replica engine's bundle
        (the replicas share ONE telemetry bus, so its ring/metrics ARE
        the tier's) plus the router's routing/scale state and every
        replica's scheduler + KV-pool snapshot."""
        lead = self.replicas[0].engine
        bundle = lead.postmortem_bundle(
            reason, detail, sched=self.replicas[0].session.sched)
        bundle["mode"] = "router"
        bundle["router"] = {
            "policy": self.policy,
            "stats": dict(self.stats),
            "inflight": len(self._inflight),
            "scale_events": list(self.scale_events[-32:]),
            "host_tier": (self.host_tier.debug_state()
                          if self.host_tier is not None else None),
        }
        bundle["replicas"] = {
            f"replica{r.idx}": {
                "live": r.live, "draining": r.draining,
                "clock_virtual_s": r.clock_s,
                "scheduler": r.session.sched.debug_state(),
                "kv_pool": r.engine.cache.debug_state(),
                "compile_counts": r.engine.compile_counts(),
            } for r in self.replicas}
        if path is None:
            path = lead._postmortem_path(reason)
        return write_json_atomic(path, bundle)
