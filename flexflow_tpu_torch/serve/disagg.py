"""Disaggregated prefill/decode serving (``flexflow_tpu/serve/
disagg.py``, whole): page-handoff engines on one card.

Why split the roles: the ONE mixed step is fixed-shape — every step
dispatches ``serve_prefill_budget + serve_max_seqs`` lanes whether or
not a prefill rides along, so under mixed traffic every DECODE token
pays the prefill budget's compute. A prefill role runs the budget-wide
step and nothing else; a decode role runs a step whose prefill budget
is a page-sized stub (enough to recompute a handoff's partial tail
page); finished KV pages cross between them as a host-side transfer.

The handoff rides the existing machinery: pages are the transfer unit
(serve/kv_cache.py) and the chain-hash prefix registry their content
identity; ``ServeEngine.export_kv`` gathers a finished slot's full
pages (values, and scale rows on int8/fp8 pools) into a
:class:`PageShipment`, ``import_kv`` parks them in the decode pool's
prefix LRU — hashed, refcount 0, matchable — and the decode role then
serves the request as a prefix-cache hit, recomputing only the tail.
So the cluster is token-identical to the unified engine by
construction. Both roles are ``ServeEngine`` instances over the model's one set
of parameter tensors, each with its own page pool and its own captured
mixed step (kernels/csrc/paged_ragged_v2.cu carries both).

Backpressure is the degradation ladder: a shipment imports only while
the decode pool stays above its admission watermark; past it the
cluster SKIPS the import (counted, an instant on the cluster track) and
the decode role re-prefills. ``serve_transport="tcp"`` sends each
shipment over a loopback socket in the JAX package's frame format
(serve/transport.py), the receiver applying the same gate. The
prefill:decode ratio comes from the placement search for
``serve_disagg_ratio="auto"`` (search/serve_place
.optimize_serve_disagg).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.telemetry import (Telemetry, serve_metrics,
                               telemetry_for)
from .engine import ServeEngine

# the cluster's telemetry track (kv_handoff spans + skip instants)
_CLUSTER_TRACK = ("serve", "cluster")


@dataclasses.dataclass
class PageShipment:
    """One slot's finished KV pages, host-side: the unit a prefill
    engine hands a decode engine. ``keys`` are the chain hashes (the
    transfer identity), ``k_rows``/``v_rows`` the page value rows as
    numpy ``(layers, n_pages, page_size, heads, head_dim)`` in the
    JAX package's layout, byte for byte: f32 and int8 pools at their
    own dtype, bf16 rows as a uint16 view and fp8 (e4m3fn) rows as a
    uint8 view (numpy has neither type). ``*_scale_rows`` are the f32
    ``(layers, n_pages, page_size, heads)`` scale rows of quantized
    pools (None otherwise). The geometry stamp lets ``import_kv``
    reject a pool-shape mismatch; ``stream_id``, ``tenant_id`` and
    ``trace_id`` carry the request's sampling stream, adapter tenant
    and trace context across the split."""

    keys: List[bytes]
    ntokens: int
    k_rows: np.ndarray
    v_rows: np.ndarray
    k_scale_rows: Optional[np.ndarray]
    v_scale_rows: Optional[np.ndarray]
    page_size: int
    num_layers: int
    num_heads: int
    head_dim: int
    kv_dtype: str
    stream_id: Optional[int] = None
    tenant_id: int = 0
    trace_id: Optional[int] = None

    def signature(self) -> tuple:
        return (self.page_size, self.num_layers, self.num_heads,
                self.head_dim, self.kv_dtype)

    @property
    def num_pages(self) -> int:
        return len(self.keys)

    @property
    def nbytes(self) -> int:
        """Host-link bytes this shipment moves (values + scale rows)."""
        n = int(self.k_rows.nbytes + self.v_rows.nbytes)
        if self.k_scale_rows is not None:
            n += int(self.k_scale_rows.nbytes
                     + self.v_scale_rows.nbytes)
        return n


def engine_for(model, **kw):
    """The config-driven serving entry point — the consumer of
    ``serve_disagg``: a :class:`DisaggCluster` (ratio per
    ``serve_disagg_ratio``: "" = 1:1, "P:D", or "auto" via the ratio
    search) when ``FFConfig.serve_disagg`` is set, else a plain
    :class:`ServeEngine`.

    The SHARED surface a flag-agnostic driver may use: ``warmup()``,
    ``generate(prompts, max_new_tokens, eos_token=, temperature=,
    top_k=, sample_seed=, on_step=)``, ``generate_reference()``,
    ``last_stats``, ``close()`` / context manager. ``on_step`` is
    arity-normalized (:func:`normalize_on_step`): the cluster accepts
    BOTH the engine's ``on_step(step)`` and its own
    ``on_step(role, engine_idx, step)``, so a hook written for one
    type cannot silently receive the wrong arguments from the other.
    Anything beyond the shared surface is type-specific — engine-only
    constructor kwargs (``faults``, ``host_tier``) — and ``**kw`` goes
    verbatim to whichever type the flag selects (``config``,
    ``device``, ``capture`` and ``telemetry`` are common to both)."""
    cfg = kw.get("config") or model.config
    if cfg.serve_disagg:
        return DisaggCluster.from_config(model, **kw)
    return ServeEngine(model, **kw)


def normalize_on_step(on_step):
    """Normalize a step hook to the cluster's canonical
    ``cb(role, engine_idx, step)`` form, accepting either arity:

      * ``on_step(step)`` — the ``ServeEngine.generate`` signature; the
        role/index context is dropped on the adapter's floor;
      * ``on_step(role, engine_idx, step)`` — the cluster-native form.

    Arity is resolved by signature binding (bound methods, partials
    and ``*args`` callables all work; a callable binding both forms is
    taken as 3-ary — the richer one). Anything that binds neither
    raises here, at arming time, instead of detonating mid-serve on
    the first step."""
    if on_step is None:
        return None
    import inspect
    try:
        sig = inspect.signature(on_step)
    except (TypeError, ValueError):
        return on_step   # uninspectable (builtin): trust 3-ary
    def binds(k):
        try:
            sig.bind(*(None,) * k)
            return True
        except TypeError:
            return False
    if binds(3):
        return on_step
    if binds(1):
        return lambda _role, _idx, step: on_step(step)
    raise TypeError(
        "on_step must accept (step) or (role, engine_idx, step); "
        f"got signature {sig}")


class DisaggCluster:
    """Prefill/decode-disaggregated serving over one model.

    Builds dedicated ``ServeEngine`` roles over the model's parameter
    tensors (one copy on the card), each with its own page pool and
    captured mixed step:

      * ``prefill_engines`` engines run the full budget-wide mixed
        program; each request prefills there with ``max_new=1`` — the
        final prefill chunk emits the FIRST token, and the finished
        prompt pages export at that boundary (generate's ``on_finish``
        hook, while the slot is still mapped);
      * ``decode_engines`` engines run a program whose prefill budget
        is ``decode_budget`` lanes (default 2 pages' worth — the stub
        that recomputes a handoff's partial tail), so a decode step
        costs the decode lanes, not the budget;
      * requests route prefill -> (page handoff) -> decode
        round-robin, with the decode pool's admission watermark as the
        handoff backpressure signal.

    Sampled streams cross the split: seeded draws key on a stream-id carried with the
    request (and stamped into its PageShipment) plus a stream offset,
    not the local scheduler's rid/token index — the prefill role draws
    index 0 of stream i, the decode role resumes stream i at offset 1,
    so seeded temperature/top-k decoding is token-identical to the
    unified engine at the same seed instead of being refused.

    Everything is synchronous host-side orchestration in one process,
    both roles' steps on the same card: the win is structural — decode
    steps stop paying for prefill lanes. Each role engine resolves
    ``serve_mesh`` itself, as JAX's do: at a degree above 1 every rank
    of the tensor group runs the same cluster, its roles sharded, and
    the shipments carry whole rows. ``config`` overrides the
    model's (as ServeEngine's does); the roles run on ``device`` (the
    card unless "cpu") and replay captured steps unless
    ``capture=False``."""

    def __init__(self, model, *, prefill_engines: int = 1,
                 decode_engines: int = 1,
                 decode_budget: Optional[int] = None,
                 spec_tokens: Optional[int] = None,
                 telemetry: Optional[Telemetry] = None,
                 config=None, device="cuda", capture: bool = True):
        if prefill_engines < 1 or decode_engines < 1:
            raise ValueError(
                f"a disaggregated cluster needs >= 1 engine per role, "
                f"got {prefill_engines}:{decode_engines}")
        self.model = model
        cfg = config if config is not None else model.config
        self.config = cfg
        self.telemetry = telemetry if telemetry is not None \
            else telemetry_for(cfg)
        ps = int(cfg.kv_page_size)
        if decode_budget is None:
            decode_budget = int(cfg.serve_disagg_decode_budget or 0)
        # the decode role's prefill stub: big enough for one handoff
        # tail chunk per admission (a tail is < page_size prompt tokens
        # + the first generated token), two pages' worth by default so
        # two requests can land per step
        self.decode_budget = int(decode_budget) if decode_budget \
            else 2 * ps
        if self.decode_budget < ps:
            raise ValueError(
                f"decode_budget ({self.decode_budget}) must cover at "
                f"least one page ({ps} tokens): the decode role "
                f"recomputes handoff tail chunks through it")
        spec = {}
        if spec_tokens is not None:
            spec = dict(serve_spec_decode=int(spec_tokens) > 0,
                        serve_spec_tokens=max(0, int(spec_tokens)))

        def role_engine(budget: int) -> ServeEngine:
            # each role: the chunked mixed step at its own budget, the
            # prefix cache the handoff lands in, and no scrape endpoint
            # (the cluster owns the one /metrics); the engines share
            # the model's parameter tensors where the model lives on
            # the card, and copy what their steps read from a model on
            # the host (their shards at t > 1)
            role_cfg = dataclasses.replace(
                cfg, serve_prefill_budget=int(budget),
                serve_chunked_prefill=True, serve_prefix_cache=True,
                metrics_port=None, **spec)
            return ServeEngine(model, role_cfg, device=device,
                               capture=capture, telemetry=self.telemetry)

        full_budget = int(cfg.serve_prefill_budget)
        self.prefill: List[ServeEngine] = [
            role_engine(full_budget) for _ in range(int(prefill_engines))]
        self.decode: List[ServeEngine] = [
            role_engine(self.decode_budget)
            for _ in range(int(decode_engines))]
        # prefill-role speculation is moot (max_new=1 never decodes);
        # leave it configured — the scheduler simply never drafts
        self.kv_exact = self.prefill[0].kv_exact
        self.stats: Dict[str, float] = {
            "handoff_requests": 0, "handoff_pages": 0,
            "handoff_bytes": 0, "handoff_dedup_pages": 0,
            "handoff_skipped": 0, "handoff_seconds": 0.0}
        self.last_stats: Optional[dict] = None
        self.placement = None   # set by from_config's "auto" path
        # (trace_id, prefill Request, decode Request) triples of the
        # last generate() — the cross-role explain_request source
        self._last_traces: List[list] = []
        # the cluster-lifetime registry the per-role TTFT/TPOT split
        # folds into (serve_metrics role labels; disagg_report reads
        # it). With telemetry enabled it IS the bus's registry (the
        # engines fold their aggregates there too); disabled, the
        # cluster keeps its own — never the shared disabled
        # singleton's, which other components would see polluted.
        from ..utils.telemetry import MetricsRegistry
        self.metrics = self.telemetry.metrics if self.telemetry.enabled \
            else MetricsRegistry()
        # the cluster owns the scrape endpoint the role engines were
        # denied (role_cfg forces metrics_port=None): metrics_port
        # under serve_disagg serves the CLUSTER registry — aggregate
        # + role-labeled series + handoff counters — from one port,
        # exactly the autoscaler poll target a unified engine exposes
        self.metrics_server = None
        mport = cfg.metrics_port
        if mport is not None:
            from ..utils.telemetry import MetricsServer
            self.metrics_server = MetricsServer(
                self.metrics.to_prometheus, port=int(mport),
                host=str(cfg.metrics_host))
        # serve_transport="tcp": shipments leave generate() as length-
        # prefixed socket frames (serve/transport.py) instead of
        # in-process handoffs. The cluster arms BOTH ends on loopback —
        # the receiver imports into this cluster's own decode pool
        # (same watermark gate, via _import_shipment) — so one process
        # exercises the full wire path; a multi-host deployment points
        # the sender at another host's receiver (open_receiver()).
        self._receiver = None
        self._sender = None
        tname = str(cfg.serve_transport or "").strip()
        if tname:
            if tname != "tcp":
                raise ValueError(
                    f"unknown serve transport {tname!r} (supported: "
                    f"'tcp', '' = in-process handoff)")
            from .transport import ShipmentSender
            self._receiver = self.open_receiver(
                host=str(cfg.serve_transport_host),
                port=int(cfg.serve_transport_port or 0))
            self._sender = ShipmentSender(self._receiver.host,
                                          self._receiver.port)

    def open_receiver(self, *, host: str = "127.0.0.1",
                      port: int = 0):
        """Start a :class:`~.transport.ShipmentReceiver` importing
        into THIS cluster's decode pool — the listening end a remote
        prefill tier's ``ShipmentSender`` targets. Admission is the
        same watermark gate as the in-process handoff; the import runs
        on the receiver's connection thread while the sender blocks on
        the ack, so at most one import mutates an engine at a time."""
        from .transport import ShipmentReceiver
        return ShipmentReceiver(self._import_shipment, host=host,
                                port=int(port))

    def _import_shipment(self, ship: PageShipment) -> dict:
        """Receiver-side import: decode-engine choice keys on the
        shipment's stream id (== the request's global index, the same
        round-robin the in-process handoff uses), so the wire path is
        placement-identical to the in-process one."""
        return self._handoff(ship, int(ship.stream_id or 0))

    @classmethod
    def from_config(cls, model, *, num_devices: Optional[int] = None,
                    **kw) -> "DisaggCluster":
        """Build a cluster from FFConfig's disaggregation knobs:
        serve_disagg_ratio "" = 1:1, "P:D" = those engine counts,
        "auto" = the placement search's ratio table
        (search/serve_place.optimize_serve_disagg over this model's
        ServeArch at `num_devices` — default: the process group's world
        size, else the visible card count, floored at 2 so the split
        exists). The winning DisaggPlacement lands on
        `cluster.placement`. As in JAX only its engine counts are used:
        each role engine resolves its own tensor degree from
        ``serve_mesh``."""
        cfg = kw.get("config") or model.config
        sr = str(cfg.serve_disagg_ratio or "").strip()
        p = d = 1
        placement = None
        if sr == "auto":
            from ..parallel.mesh import serve_devices
            from ..search.serve_place import optimize_serve
            from .engine import probe_serve_arch
            ndev = int(num_devices) if num_devices else max(
                2, serve_devices())
            ps = int(cfg.kv_page_size)
            stub = int(cfg.serve_disagg_decode_budget or 0) or 2 * ps
            # price the decode role at the stub width the cluster will
            # build (priced like executed)
            arch = dataclasses.replace(probe_serve_arch(model, cfg),
                                       handoff_stub_lanes=stub)
            placement = optimize_serve(arch, ndev, config=cfg,
                                       disaggregated=True)
            p, d = (placement.prefill_engines,
                    placement.decode_engines)
        elif sr:
            p, d = (int(x) for x in sr.split(":"))
        cluster = cls(model, prefill_engines=p, decode_engines=d, **kw)
        cluster.placement = placement
        return cluster

    # ---------------- role plumbing ------------------------------------
    def engines(self) -> List[Tuple[str, ServeEngine]]:
        return ([("prefill", e) for e in self.prefill]
                + [("decode", e) for e in self.decode])

    def warmup(self) -> Dict[str, Dict[str, int]]:
        """Compile every role's mixed program AND the handoff
        export/import programs; after this the cluster never compiles
        (compile_counts drift is the zero-recompile gate)."""
        out = {}
        for i, (role, eng) in enumerate(self.engines()):
            eng.warmup()
            out[f"{role}{i}"] = eng.warmup_handoff()
        return out

    def compile_counts(self) -> Dict[str, Dict[str, int]]:
        return {f"{role}{i}": eng.compile_counts()
                for i, (role, eng) in enumerate(self.engines())}

    def check_invariants(self) -> None:
        for _, eng in self.engines():
            eng.cache.check_invariants()
            if eng.adapters is not None:
                eng.adapters.check_invariants()

    def register_adapter(self, tenant_id: int, weights, *,
                         scale: float = 1.0) -> None:
        """Register a tenant's LoRA adapter on EVERY role engine: a
        request may prefill on any prefill engine and decode on any
        decode engine, so the registry must be cluster-uniform."""
        for _, eng in self.engines():
            eng.register_adapter(tenant_id, weights, scale=scale)

    def close(self) -> None:
        server, self.metrics_server = self.metrics_server, None
        if server is not None:
            server.close()
        sender, self._sender = self._sender, None
        if sender is not None:
            sender.close()
        receiver, self._receiver = self._receiver, None
        if receiver is not None:
            receiver.close()
        for _, eng in self.engines():
            eng.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------- the handoff --------------------------------------
    def _admit_shipment(self, eng: ServeEngine, ship: PageShipment
                        ) -> bool:
        """Backpressure: import only while the decode pool can hold
        the new pages AND stay above its admission watermark — the
        same planning-visible pressure signal the degradation ladder
        reads. Past it the shipment is dropped and the decode engine
        re-prefills (rung-2 behavior: stop pinning reclaimable pages
        when admissions are starved)."""
        need = sum(1 for k in ship.keys
                   if not eng.cache.key_resident(k))
        headroom = eng.cache.free_pages - need
        from .scheduler import watermark_pages
        wm = watermark_pages(eng.admit_watermark,
                             eng.cache_cfg.usable_pages)
        return headroom >= max(wm, 1)

    def _ship(self, ship: Optional[PageShipment], rid) -> None:
        """Route one shipment toward the decode pool: over the armed
        socket transport when serve_transport is set (send blocks for the
        receiver's ack — the wire's backpressure), else the in-process
        handoff."""
        if ship is None:
            return
        if self._sender is not None:
            self._sender.send(ship)
        else:
            self._handoff(ship, rid)

    def _handoff(self, ship: Optional[PageShipment], rid) -> dict:
        """Move one shipment prefill -> decode (round-robin by rid),
        emitting the kv_handoff span + transfer counters. Returns the
        ack dict the socket receiver forwards to its sender."""
        if ship is None:
            return {"accepted": False, "pages_written": 0}
        eng = self.decode[rid % len(self.decode)]
        tel = self.telemetry
        t0 = time.perf_counter()
        if not self._admit_shipment(eng, ship):
            self.stats["handoff_skipped"] += 1
            if tel.enabled:
                tel.instant(_CLUSTER_TRACK, "kv_handoff_skipped",
                            args={"rid": rid, "pages": ship.num_pages,
                                  "trace": ship.trace_id})
            return {"accepted": False, "pages_written": 0}
        before_dedup = eng.cache.stats["import_dedup_pages"]
        written = eng.import_kv(ship)
        dt = time.perf_counter() - t0
        dedup = eng.cache.stats["import_dedup_pages"] - before_dedup
        nbytes = ship.nbytes * written // max(1, ship.num_pages)
        self.stats["handoff_requests"] += 1
        self.stats["handoff_pages"] += written
        self.stats["handoff_bytes"] += nbytes
        self.stats["handoff_dedup_pages"] += dedup
        self.stats["handoff_seconds"] += dt
        if tel.enabled:
            tel.span(_CLUSTER_TRACK, "kv_handoff", t0, t0 + dt,
                     args={"rid": rid, "pages": written,
                           "dedup_pages": dedup, "bytes": nbytes,
                           "trace": ship.trace_id})
            tel.metrics.inc("kv_transfer_bytes_total", nbytes)
            tel.metrics.inc("kv_transfer_pages_total", written)
        return {"accepted": True, "pages_written": written}

    # ---------------- the serving loop ---------------------------------
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens, eos_token: Optional[int] = None,
                 temperature=None, top_k=None, sample_seed: int = 0,
                 on_step=None,
                 tenant_ids: Optional[Sequence[int]] = None
                 ) -> List[List[int]]:
        """Serve a batch disaggregated: prefill engines compute every
        prompt and its FIRST token, finished pages hand off to decode
        engines, which emit the rest. Token-identical to the unified
        ``ServeEngine.generate`` on lossless pools (the quantized
        contract relaxes exactly as it does everywhere else). Greedy /
        top_k=1 only (see class docstring). ``on_step`` observes every
        role engine's steps (the per-pool invariant hook of the
        property tests) — either arity, ``on_step(step)`` or
        ``on_step(role, engine_idx, step)``, via
        :func:`normalize_on_step`."""
        on_step = normalize_on_step(on_step)
        n = len(prompts)

        def per_req(x, name):
            """Broadcast a scalar/None arg to one entry per request —
            the waves below slice these, so every role engine sees
            exactly its requests' entries."""
            if x is None or np.isscalar(x):
                return [x] * n
            x = list(x)
            if len(x) != n:
                raise ValueError(
                    f"{name} has {len(x)} entries for {n} prompts")
            return x

        temps = per_req(temperature, "temperature")
        tks = per_req(top_k, "top_k")
        # tenancy crosses the split with the request: the prefill role
        # computes the salted chain + adapted K/V, the shipment stamps
        # the tenant, and the decode role re-admits under the same id
        tens = per_req(0 if tenant_ids is None else list(tenant_ids),
                       "tenant_ids")
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * n
        if len(max_new_tokens) != n:
            raise ValueError(
                f"max_new_tokens has {len(max_new_tokens)} entries "
                f"for {n} prompts")
        for mnt in max_new_tokens:
            if int(mnt) < 1:
                # mirror scheduler.submit's contract up front: the
                # prefill role would otherwise silently serve 1 token
                # where the unified engine refuses
                raise ValueError(
                    f"max_new_tokens must be >= 1, got {mnt}")
        t_start = time.perf_counter()
        tel = self.telemetry
        stats0 = dict(self.stats)  # lifetime counters: fold the DELTA
        # ONE trace id per request for its WHOLE disaggregated life:
        # the prefill-role spans, the kv_handoff span (via the
        # PageShipment) and the decode-role spans all carry it, so the
        # exported trace holds one causally-linked timeline per
        # request across the split
        from ..utils.telemetry import next_trace_id
        tids = [next_trace_id() for _ in range(n)]
        # (trace_id, prefill Request, decode Request) per request —
        # the explain_request / fold_attribution source
        self._last_traces = [[tids[i], None, None] for i in range(n)]

        # ---- phase 1: prefill role (+ export at each finish) ----------
        # round-robin the batch over the prefill engines; every request
        # runs max_new=1, so the mixed program only ever carries
        # prefill chunks and each request's finish IS its first token
        first: List[Optional[int]] = [None] * n
        ships: List[Optional[PageShipment]] = [None] * n
        waves: List[List[int]] = [[] for _ in self.prefill]
        for i in range(n):
            waves[i % len(self.prefill)].append(i)
        pre_stats: List[dict] = []
        for w, (eng, idxs) in enumerate(zip(self.prefill, waves)):
            if not idxs:
                continue
            local = {}

            def grab(req, _eng=eng, _local=local, _idxs=idxs):
                # rids are assigned in submit order within this wave;
                # skip the export entirely for requests phase 3 will
                # drop anyway (max_new=1, or eos as the first token) —
                # no point gathering and copying pages nobody imports
                i = _idxs[req.rid]
                if max_new_tokens[i] <= 1 or (
                        eos_token is not None and req.out_tokens
                        and req.out_tokens[-1] == eos_token):
                    return
                _local[req.rid] = _eng.export_kv(
                    req.slot, req.context, stream_id=req.stream_id,
                    trace_id=req.trace_id, tenant_id=req.tenant_id)

            # stream ids = GLOBAL request indices (the identity a
            # unified engine's rids would be), so sampled draws on
            # either side of the split reproduce the unified stream
            out = eng.generate(
                [prompts[i] for i in idxs], 1, eos_token=eos_token,
                temperature=[temps[i] for i in idxs],
                top_k=[tks[i] for i in idxs],
                sample_seed=sample_seed, on_finish=grab,
                stream_ids=list(idxs),
                trace_ids=[tids[i] for i in idxs],
                tenant_ids=[tens[i] for i in idxs],
                on_step=(None if on_step is None else
                         (lambda s, _w=w: on_step("prefill", _w, s))))
            for rid, i in enumerate(idxs):
                # an aborted prefill (deadline expiry, fault-failed
                # in-flight) returns NO tokens — mirror the unified
                # engine's empty output instead of crashing the batch
                first[i] = out[rid][0] if out[rid] else None
                ships[i] = local.get(rid)
                self._last_traces[i][1] = eng._last_reqs.get(rid)
            pre_stats.append(eng.last_stats)

        # which requests actually continue to the decode role: done-at-
        # first-token requests (max_new=1, eos on the first token, or
        # aborted before emitting) ship NOTHING — their pages would
        # only park in the decode pool and compete with real handoffs
        # for backpressure headroom
        decode_idx = [i for i in range(n)
                      if first[i] is not None
                      and max_new_tokens[i] > 1
                      and not (eos_token is not None
                               and first[i] == eos_token)]

        # ---- phase 2: page handoff (with backpressure) ----------------
        for i in decode_idx:
            self._ship(ships[i], i)

        # ---- phase 3: decode role -------------------------------------
        # each surviving request continues as prompt + [first token]
        # with max_new - 1 budget; the decode engine admits it as a
        # prefix-cache hit over the imported pages and recomputes only
        # the tail chunk
        results: List[List[int]] = [
            [] if t is None else [t] for t in first]
        dec_stats: List[dict] = []
        dwaves: List[List[int]] = [[] for _ in self.decode]
        for i in decode_idx:
            dwaves[i % len(self.decode)].append(i)
        for w, (eng, idxs) in enumerate(zip(self.decode, dwaves)):
            if not idxs:
                continue
            # the decode role RESUMES each stream at offset 1: the
            # prefill role already drew token-index 0 (the first
            # token), so the continuation's draws line up with the
            # unified engine's indices 1..max_new-1
            out = eng.generate(
                [list(prompts[i]) + [first[i]] for i in idxs],
                [max_new_tokens[i] - 1 for i in idxs],
                eos_token=eos_token,
                temperature=[temps[i] for i in idxs],
                top_k=[tks[i] for i in idxs],
                sample_seed=sample_seed,
                stream_ids=list(idxs), stream_offset=1,
                trace_ids=[tids[i] for i in idxs],
                tenant_ids=[tens[i] for i in idxs],
                on_step=(None if on_step is None else
                         (lambda s, _w=w: on_step("decode", _w, s))))
            for j, i in enumerate(idxs):
                results[i].extend(out[j])
                self._last_traces[i][2] = eng._last_reqs.get(j)
            dec_stats.append(eng.last_stats)

        wall = time.perf_counter() - t_start
        total_new = sum(len(r) for r in results)
        self.last_stats = {
            "mode": "disagg",
            "pipelined": False,
            "transport": ("tcp" if self._sender is not None
                          else "inproc"),
            "prefill_engines": len(self.prefill),
            "decode_engines": len(self.decode),
            "decode_budget": self.decode_budget,
            "wall_s": wall,
            "total_new_tokens": total_new,
            "tokens_per_sec": total_new / wall if wall > 0 else 0.0,
            # THIS call's handoff accounting (self.stats stays the
            # cluster-lifetime totals) — per-call numbers must sit
            # next to per-call wall_s/tokens
            "handoff": {k: self.stats[k] - stats0[k]
                        for k in self.stats},
            "roles": {"prefill": pre_stats, "decode": dec_stats},
            "compile_counts": self.compile_counts(),
        }
        # fold the per-role latency split into the cluster registry —
        # what disagg_report renders from. With telemetry enabled the
        # role engines already folded the UNLABELED aggregates into
        # this same registry after their generates, so only the
        # role-labeled series are added here; disabled, the cluster
        # owns its registry and folds both.
        m = self.metrics
        for st in pre_stats:
            if not tel.enabled:
                serve_metrics(st, registry=m)
            serve_metrics(st, registry=m, role="prefill")
        for st in dec_stats:
            if not tel.enabled:
                serve_metrics(st, registry=m)
            serve_metrics(st, registry=m, role="decode")
        def delta(k):
            return self.stats[k] - stats0[k]

        m.inc("kv_handoff_requests_total", delta("handoff_requests"))
        m.inc("kv_handoff_skipped_total", delta("handoff_skipped"))
        if not tel.enabled:
            # with telemetry on, _handoff already counted these on the
            # (same) registry per shipment
            m.inc("kv_transfer_bytes_total", delta("handoff_bytes"))
            m.inc("kv_transfer_pages_total", delta("handoff_pages"))
        return results

    # ---------------- the pipelined serving loop ------------------------
    def generate_pipelined(self, prompts: Sequence[Sequence[int]],
                           max_new_tokens,
                           eos_token: Optional[int] = None,
                           temperature=None, top_k=None,
                           sample_seed: int = 0, on_step=None,
                           tenant_ids: Optional[Sequence[int]] = None
                           ) -> List[List[int]]:
        """Serve the batch with CONTINUOUS prefill/decode pipelining:
        one event loop drives every role engine's steppable
        ``ServeSession``, so the moment a request's prefill finishes
        its pages hand off and its continuation is admitted to a
        decode engine — while the remaining prefills are still
        running. Both roles' programs stay busy concurrently instead
        of the phased generate()'s prefill-wave -> handoff ->
        decode-wave barriers; per-request TTFT stops paying for the
        rest of the batch's prefill wave.

        TOKEN-IDENTICAL to the phased ``generate`` (and the unified
        engine) by the same construction: stream ids are the global
        request indices, the decode continuation resumes each stream
        at offset 1, and the handoff/admission path is byte-for-byte
        the one the phased loop uses — the loop only reorders WHEN
        steps run, never what they compute. With ``serve_transport="tcp"``
        each shipment crosses the socket (the ack blocks this loop, so
        the receiver's import never races a decode step).

        ``on_step`` accepts either hook arity (normalize_on_step)."""
        on_step = normalize_on_step(on_step)
        n = len(prompts)

        def per_req(x, name):
            if x is None or np.isscalar(x):
                return [x] * n
            x = list(x)
            if len(x) != n:
                raise ValueError(
                    f"{name} has {len(x)} entries for {n} prompts")
            return x

        tens = per_req(0 if tenant_ids is None else list(tenant_ids),
                       "tenant_ids")
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * n
        if len(max_new_tokens) != n:
            raise ValueError(
                f"max_new_tokens has {len(max_new_tokens)} entries "
                f"for {n} prompts")
        for mnt in max_new_tokens:
            if int(mnt) < 1:
                raise ValueError(
                    f"max_new_tokens must be >= 1, got {mnt}")
        lead = self.prefill[0]
        samples = lead._sample_params(temperature, top_k, sample_seed,
                                      n, lead.topk_cap)
        t_start = time.perf_counter()
        tel = self.telemetry
        stats0 = dict(self.stats)
        from ..utils.telemetry import next_trace_id
        tids = [next_trace_id() for _ in range(n)]
        self._last_traces = [[tids[i], None, None] for i in range(n)]

        first: List[Optional[int]] = [None] * n
        ships: List[Optional[PageShipment]] = [None] * n
        dreqs: Dict[int, object] = {}
        psess = [eng.start_session() for eng in self.prefill]
        dsess = [eng.start_session() for eng in self.decode]
        try:
            for i in range(n):
                w = i % len(self.prefill)

                def grab(req, _eng=self.prefill[w], _i=i):
                    # export at the finish boundary, slot still
                    # mapped — skipped for requests the decode role
                    # will never see (phased generate's rule)
                    if max_new_tokens[_i] <= 1 or (
                            eos_token is not None and req.out_tokens
                            and req.out_tokens[-1] == eos_token):
                        return
                    ships[_i] = _eng.export_kv(
                        req.slot, req.context,
                        stream_id=req.stream_id,
                        trace_id=req.trace_id,
                        tenant_id=req.tenant_id)

                psess[w].submit(
                    prompts[i], 1, eos_token=eos_token,
                    sample=samples[i], stream_id=i,
                    trace_id=tids[i], tenant_id=tens[i],
                    on_finish=grab)

            def step_role(role, engines, sessions):
                """One step on every busy engine of a role; returns
                the finished requests per engine index."""
                fins = []
                for w, eng in enumerate(engines):
                    s = sessions[w]
                    if not s.has_work():
                        continue
                    try:
                        ev = s.step()
                    except Exception:
                        # contain per engine, phased-generate style:
                        # fail its in-flight requests, keep the rest
                        # of the cluster serving
                        eng._fail_inflight(s.sched, s.reqs)
                        s.close()
                        sessions[w] = eng.start_session()
                        continue
                    if ev is None:
                        continue
                    if on_step is not None:
                        on_step(role, w, ev)
                    for req in ev.finished:
                        fins.append(req)
                return fins

            while any(s.has_work() for s in psess) \
                    or any(s.has_work() for s in dsess):
                for req in step_role("prefill", self.prefill, psess):
                    i = req.stream_id
                    ft = req.out_tokens[0] if req.out_tokens else None
                    first[i] = ft
                    self._last_traces[i][1] = req
                    if ft is None or max_new_tokens[i] <= 1 or (
                            eos_token is not None
                            and ft == eos_token):
                        continue
                    # the pipelining: handoff + decode admission NOW,
                    # not after the whole prefill wave
                    self._ship(ships[i], i)
                    d = i % len(self.decode)
                    dreqs[i] = dsess[d].submit(
                        list(prompts[i]) + [ft],
                        int(max_new_tokens[i]) - 1,
                        eos_token=eos_token, sample=samples[i],
                        stream_id=i, stream_offset=1,
                        trace_id=tids[i], tenant_id=tens[i])
                    self._last_traces[i][2] = dreqs[i]
                step_role("decode", self.decode, dsess)
            pre_stats = [s.stats_dict() for s in psess if s.reqs]
            dec_stats = [s.stats_dict() for s in dsess if s.reqs]
        finally:
            for s in psess + dsess:
                try:
                    s.close()
                except Exception:
                    pass
        results: List[List[int]] = []
        for i in range(n):
            if first[i] is None:
                results.append([])
            elif i in dreqs:
                results.append([first[i]]
                               + list(dreqs[i].out_tokens))
            else:
                results.append([first[i]])
        wall = time.perf_counter() - t_start
        total_new = sum(len(r) for r in results)
        self.last_stats = {
            "mode": "disagg",
            "pipelined": True,
            "transport": ("tcp" if self._sender is not None
                          else "inproc"),
            "prefill_engines": len(self.prefill),
            "decode_engines": len(self.decode),
            "decode_budget": self.decode_budget,
            "wall_s": wall,
            "total_new_tokens": total_new,
            "tokens_per_sec": total_new / wall if wall > 0 else 0.0,
            "handoff": {k: self.stats[k] - stats0[k]
                        for k in self.stats},
            "roles": {"prefill": pre_stats, "decode": dec_stats},
            "compile_counts": self.compile_counts(),
        }
        # sessions never auto-fold (unlike generate(), where each role
        # engine folds its unlabeled aggregates after its wave), so
        # fold both the aggregate and the role-labeled series here
        m = self.metrics
        for st in pre_stats:
            serve_metrics(st, registry=m)
            serve_metrics(st, registry=m, role="prefill")
        for st in dec_stats:
            serve_metrics(st, registry=m)
            serve_metrics(st, registry=m, role="decode")

        def delta(k):
            return self.stats[k] - stats0[k]

        m.inc("kv_handoff_requests_total", delta("handoff_requests"))
        m.inc("kv_handoff_skipped_total", delta("handoff_skipped"))
        if not tel.enabled:
            m.inc("kv_transfer_bytes_total", delta("handoff_bytes"))
            m.inc("kv_transfer_pages_total", delta("handoff_pages"))
        return results

    # ---------------- observability --------------------------------------
    def explain_request(self, index: int) -> dict:
        """Cross-role latency attribution for request `index` of the
        last generate(): ONE trace id ties the
        prefill-role spans, the kv_handoff transfer span and the
        decode-role spans together, so the breakdown spans the whole
        disaggregated life — measured from the prefill submit stamp to
        the decode finish stamp (prefill finish when the request never
        crossed the link). Batch-phase orchestration time (other
        requests' waves) lands in ``other`` — honestly unattributable
        to this request's critical path."""
        if not self.telemetry.enabled:
            raise RuntimeError(
                "explain_request needs telemetry (pass telemetry= or "
                "set FFConfig.telemetry / trace_out)")
        if not (0 <= index < len(self._last_traces)):
            raise KeyError(
                f"request index {index} not in the last generate "
                f"({len(self._last_traces)} requests)")
        tid, pre, dec = self._last_traces[index]
        if pre is None or not pre.t_finish:
            raise ValueError(
                f"request {index} has no terminated prefill-role "
                f"request to attribute")
        t_finish = dec.t_finish if dec is not None and dec.t_finish \
            else pre.t_finish
        out = self.telemetry.explain_request(tid, pre.t_submit,
                                             t_finish)
        out.update(index=index,
                   outcome=(dec.outcome if dec is not None
                            else pre.outcome),
                   crossed_link=dec is not None)
        return out

    def fold_attribution(self, registry=None) -> dict:
        """Fold every attributable request of the last generate() into
        `registry` (default: the cluster registry) — the aggregate
        `serve_latency_attribution_*` series (utils/telemetry
        .fold_attribution)."""
        from ..utils.telemetry import (REQUEST_COMPONENTS,
                                       fold_attribution)
        m = registry if registry is not None else self.metrics
        totals = {c: 0.0 for c in REQUEST_COMPONENTS}
        if not self.telemetry.enabled:
            return totals   # no spans to attribute (router-fold rule)
        for i in range(len(self._last_traces)):
            try:
                b = self.explain_request(i)
            except (ValueError, KeyError):
                continue
            fold_attribution(b, m)
            for c, v in b["components"].items():
                totals[c] += v
        return totals

    def dump_postmortem(self, path: Optional[str] = None,
                        reason: str = "manual",
                        detail: Optional[dict] = None) -> str:
        """Cluster flight-recorder dump: the lead prefill engine's
        bundle (the roles share ONE telemetry bus, so its ring/metrics
        ARE the cluster's) plus per-role KV-pool state and compile
        counts, and the cluster's handoff accounting."""
        from ..utils.telemetry import write_json_atomic
        lead = self.prefill[0]
        bundle = lead.postmortem_bundle(reason, detail)
        bundle["mode"] = "disagg"
        bundle["handoff"] = dict(self.stats)
        bundle["roles"] = {
            f"{role}{i}": {"kv_pool": eng.cache.debug_state(),
                           "compile_counts": eng.compile_counts()}
            for i, (role, eng) in enumerate(self.engines())}
        if path is None:
            path = lead._postmortem_path(reason)
        return write_json_atomic(path, bundle)

    # ---------------- reference / ledger --------------------------------
    def generate_reference(self, prompts, max_new_tokens,
                           eos_token=None) -> List[List[int]]:
        """The no-cache greedy oracle (one engine's reference — they
        share the model's params)."""
        return self.prefill[0].generate_reference(
            prompts, max_new_tokens, eos_token=eos_token)

    def memory_ledger(self) -> dict:
        """Cluster-wide HBM accounting: BOTH roles' pools summed (the
        satellite contract — a disaggregated deployment's gauges must
        not undercount by reporting one role), with the per-role
        ledgers attached and the serve_hbm_bytes gauges emitted per
        (component, role) plus the cluster totals."""
        tel = self.telemetry
        roles = {}
        totals = {"params_bytes": 0.0, "kv_pool_bytes": 0.0,
                  "activation_est_bytes": 0.0, "adapter_bytes": 0.0,
                  "total_bytes": 0.0, "live_bytes": 0.0}
        for i, (role, eng) in enumerate(self.engines()):
            led = eng.memory_ledger()
            roles[f"{role}{i}"] = led
            for k in totals:
                totals[k] += float(led.get(k) or 0.0)
            if tel.enabled:
                for comp in ("params", "kv_pool", "activation_est",
                             "adapter", "total", "live"):
                    tel.metrics.set("serve_hbm_bytes",
                                    led[f"{comp}_bytes"],
                                    component=comp, role=f"{role}{i}")
        if tel.enabled:
            for k, v in totals.items():
                tel.metrics.set("serve_hbm_bytes", v,
                                component=k[:-len("_bytes")],
                                role="cluster")
        return {"mode": "disagg", "roles": roles, **totals}
