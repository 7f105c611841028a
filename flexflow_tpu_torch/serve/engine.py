"""ServeEngine: one fixed-shape MIXED step over a paged KV cache.

Counterpart of ``flexflow_tpu/serve/engine.py`` on one device: chunked
prefill, prefix cache, speculative decoding, float32, bfloat16, int8 or
float8_e4m3 pages, the legacy bucket path
(``serve_chunked_prefill=False``), per-lane LoRA adapters
(``adapter_rank``) and the host-RAM tier below the page pool
(``host_tier_mb``).

Each step packs `serve_prefill_budget + serve_max_seqs` LANES, each one
(sequence, position) query token: prompt chunks from any number of
requests and the decode token of every running sequence (plus its
speculative drafts). Per layer, every lane's K/V is written into its
sequence's pages, then every lane attends through its page-table row
masked at its own position + 1 (the ragged paged-attention kernel,
kernels/paged_ragged_v2.py), so causality inside a chunk is exact and
decode lanes see every prefix page — including pages another request's
chunk computes in this very step. Logits reduce to a greedy argmax and
a static top-k head before leaving the device.

Quantized pools (int8 / float8_e4m3) quantize each (lane, head) K/V row
on write against its own f32 scale, in the per-page scale arrays, and
the ragged kernel dequantizes at read.

The legacy bucket path runs two steps instead of one: each request's
prompt is forwarded alone, padded to a power-of-two bucket, scattering
its K/V into its pages (the same ``_forward_tokens`` that computes the
no-cache reference), and every running sequence then decodes one token
a step through the paged-decode kernel (kernels/flash_attention.py
``paged_attention_decode``).

The engine serves an FFModel of ``build_transformer_lm`` (compiling
it for inference when it has no state yet), reading its architecture
off the graph and its LIVE parameter tensors, as the JAX engine does: a
model trained in between is served without a reload.

Every step is one program of the engine's ProgramRegistry
(core/programs.py), in the JAX engine's families: ``mixed``, or on the
legacy path ``prefill`` (one per bucket) and ``decode``. On the card
the first step of each is captured as a CUDA graph (``warmup`` does
it) and every later step replays it: the host packs the step's lane
arrays into one pinned buffer, one asynchronous copy fills the graph's
static input, and the step's (greedy, top-k values, top-k ids) come
back packed in one copy into pinned memory. ``compile_counts()`` counts
the captures; after ``warmup`` it must not grow.

Host-side state (page allocator, prefix registry, scheduler, drafter)
is the JAX package's, copied; the engine owns the device half.

Robustness and observability are the JAX engine's: faults fire at the
dispatch boundary (``serve.mixed``, ``serve.prefill``,
``serve.decode``) before anything is staged, a ``TransientError`` is
retried up to ``serve_max_retries`` times with exponential backoff,
``cancel(rid)`` and per-request deadlines abort requests at the top of
a step, a failed step fails only the in-flight requests, and, with
telemetry on, every step is recorded as spans on the engine's tracks
(after its dispatch returned: nothing is recorded inside a captured
region), folded into the metrics registry, explained per request and
black-boxed in post-mortem bundles under ``postmortem_dir``.

LoRA adapters (serve/adapters.py): each tenant's (A, B) factors live
in fixed device slabs (slot 0 the zero slab of the base model); every
lane of the mixed step gathers its tenant's slot and adds the low-rank
deltas to qkv, wo, ff1 (before the activation) and ff2. A tenant load
copies its rows into its slot in place, outside any captured step, so
a captured mixed step reads it — the CUDA-graph counterpart of JAX's
donated load. The deltas are plain torch products, as they are XLA
products in the JAX engine.

Page export and import (``export_kv``, ``import_kv``) move whole page
rows between the pool and host numpy in the JAX layout; the host tier
(serve/host_tier.py) spills evicted prefix pages through the export
and reloads a priced host hit through the import, which writes the
live pool tensors in place.

Every step is priced by the port's serve cost stack (search/): the
prediction is a drift sample beside the measured step, the price of a
host-tier reload's recompute side, and the replica pool's virtual step.
``memory_ledger`` accounts the engine's device bytes in the JAX
schema. The disaggregated roles are engines of this class built by
``serve/disagg.DisaggCluster``.

Tensor-parallel serving (``tensor_parallel=t``, ``mesh=`` a mesh with a
``tensor`` axis, or ``serve_mesh`` "N" / "auto"): the JAX engine is one
controller driving shard_map over t devices; the port runs one process
a rank of a ``torch.distributed`` group of t ranks
(``parallel.mesh.init_distributed`` on every rank first), each rank an
engine of its own. Every rank runs the whole host program — scheduler,
prefix cache, page tables, sampling — and only the mixed step is
sharded: each rank holds H/t heads of every attention layer and of the
page pool, a column block of ff1, a row block of ff2 and a vocab block
of the embedding and the head (``_shard_params``, taken once at
construction as JAX's are, from a model on the card or on the host: a
model on the host leaves only its shards on each card), and runs
kernel 1 on its heads; each layer
all-reduces after wo and before ff2's bias, the embedding once (exact)
and the logits are all-gathered, so every rank samples the same tokens
(``models/transformer.ShardedLM``). Before every sharded step the ranks
check that they are about to feed it the same lane buffer, and the
deadline sweep reads rank 0's clock only (``parallel/collectives
.Lockstep``): a rank given other requests raises on every rank instead
of hanging or serving wrong tokens. Page export gathers the head shards
into whole one-device rows; import takes whole rows and keeps the
rank's heads, so shipments and host-tier pages interchange with
one-device engines. Under NCCL the step is captured with its
collectives; gloo ranks sharing a card stage every collective through
host memory and need ``capture=False``. The legacy bucket path serves
one device only, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CompMode, FFConfig, resolve_device
from ..core.precision import dtype_name
from ..core.programs import (PinnedRing, ProgramRegistry,
                             runtime_identity)
from ..kernels.flash_attention import (paged_attention_decode,
                                       paged_attention_ragged)
from ..kernels.paged_ragged_v2 import quantize_kv_rows
from ..models.transformer import TransformerLM
from ..utils.faults import FaultInjector, TransientError, injector_for
from ..utils.telemetry import (PACKED, REQUEST_COMPONENTS, MetricsServer,
                               Telemetry, fold_attribution, pow2_bucket,
                               serve_metrics, telemetry_for,
                               write_json_atomic)
from ..weights import arch_from_model
from .adapters import AdapterConfig, AdapterPool, tenant_prefix_salt
from .host_tier import HostPageStore
from .kv_cache import KVCacheConfig, PagedKVCache
from .scheduler import (ChunkPlan, ContinuousBatchingScheduler, Request,
                        RequestOutcome, RequestState, SampleParams)


def _serve_arch(arch, cfg, acfg, context: int):
    from ..search.cost_model import ServeArch
    from .kv_cache import QUANTIZED_KV_DTYPES, kv_storage_dtype
    kv_name = str(cfg.kv_dtype)
    return ServeArch(
        num_layers=arch.num_layers, hidden=arch.hidden,
        num_heads=arch.num_heads, head_dim=arch.head_dim,
        ff_dim=arch.ff_dim, vocab=arch.vocab,
        decode_lanes=int(cfg.serve_max_seqs),
        prefill_lanes=int(cfg.serve_prefill_budget),
        context=int(context),
        kv_dtype=kv_name,
        kv_itemsize=float(kv_storage_dtype(kv_name).itemsize),
        kv_scales=kv_name in QUANTIZED_KV_DTYPES,
        act_itemsize=float(arch.dtype.itemsize),
        act_dtype=dtype_name(arch.dtype),
        adapter_rank=acfg.rank if acfg is not None else 0,
        adapter_slots=acfg.num_slots if acfg is not None else 0)


def probe_serve_arch(model, config=None, context=None):
    """The ServeArch a ServeEngine over ``model`` and ``config`` would
    price, without building the engine — what ReplicaPool's
    ``serve_replicas="auto"`` feeds the 2-D mesh search before any
    replica exists: decode lanes = the slot reserve, prefill lanes =
    the budget, steady-state context = 3/4 of the learned positions,
    the adapter pool's geometry from the ``adapter_*`` knobs."""
    cfg = config if config is not None else model.config
    arch = arch_from_model(model)
    acfg = None
    if int(cfg.adapter_rank) > 0:
        acfg = AdapterConfig.from_ff(
            cfg, num_layers=arch.num_layers, hidden=arch.hidden,
            num_heads=arch.num_heads, head_dim=arch.head_dim,
            ff_dim=arch.ff_dim, act_itemsize=int(arch.dtype.itemsize))
    return _serve_arch(arch, cfg, acfg,
                       context if context is not None
                       else max(1, arch.max_positions * 3 // 4))


# pad bias for vocab columns the head padding invents (vocab % t != 0):
# a padded logit must never win argmax or enter the top-k window
_PAD_LOGIT_BIAS = -1e30

# the dimension of one tenant's (L, ...) adapter rows that a tensor-
# parallel engine splits (JAX's _adapter_specs): B factors where their
# output is sharded (heads, padded ff), A factors where they contract a
# sharded dimension (wo's heads, ff2's ff); the other slabs replicate
_ADAPTER_SPLIT = {"b_qkv": 3, "a_wo": 1, "b_ff1": 2, "a_ff2": 1}


def _on_card(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lives on the engine's ``device``, where a step may
    read it in place. A tensor anywhere else (a model kept on the host)
    reaches the device only as the copies a step or a reference path
    reads."""
    return t.device == device


def card_param_bytes(model, device) -> float:
    """The bytes of ``model``'s own parameters that live on ``device``:
    what an engine of degree t > 1 over the model holds on its card
    beside its shards, which the ``"auto"`` searches price at every
    degree above 1 (``resident_bytes``). 0 for a model kept on the
    host."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return float(sum(t.nbytes for ws in model.state.params.values()
                     for t in ws.values() if _on_card(t, dev)))


def _serving_params(model):
    """The LM's whole parameter tensors: the model's live ones, except
    where an executing mesh splits a weight (attention ``head``, Linear
    ``channel_out``, Embedding ``vocab`` blocks): those are gathered from
    the ranks' blocks to the host (every rank builds the engine; copies,
    taken once at construction), so no rank's card holds a whole copy
    beside the model's blocks. A data mesh's parameters are replicated
    and stay live references."""
    ex = getattr(model, "executor", None)
    bm = getattr(ex, "bm", None)
    params = model.state.params
    if bm is None:
        return params
    from ..parallel.sharding import gather

    def whole(v, spec):
        g = gather(v, spec, bm)
        return g if g is v else g.cpu()

    with torch.no_grad():
        return {op: {k: whole(v, ex._wstore[op][k])
                     for k, v in ws.items()}
                for op, ws in params.items()}


class ServeEngine:
    """Continuous-batching generation over an FFModel of
    :func:`~flexflow_tpu_torch.build_transformer_lm`.

    Serving knobs come from ``config`` (an FFConfig; the model's when
    None). Runs on the card unless ``device="cpu"``. The model lives on
    the same device, or on the host, the way to serve a model larger
    than one card: the engine then copies to its device only what its
    step reads (a rank's shards at t > 1, the whole parameters once at
    t = 1), and the reference paths copy the whole parameters for the
    call only (:meth:`generate_reference`). ``capture=False`` runs every
    step eagerly instead of replaying its captured CUDA graph (the
    reference runs of the tests and the smoke; the tokens are the
    same). ``faults`` and
    ``telemetry`` override the injector and the telemetry bus the
    config resolves (``fault_spec``; ``telemetry``, ``trace_out``,
    ``metrics_port``, ``postmortem_dir``), as the JAX engine's do;
    ``host_tier`` is a shared :class:`HostPageStore` (a replica pool's)
    that wins over the private one ``host_tier_mb`` arms.
    ``tensor_parallel`` or ``mesh`` (a mesh description with a
    ``tensor`` axis) shards the mixed step over that many ranks of the
    running process group, one engine a rank (module docstring); they
    win over ``serve_mesh``."""

    # static top-k head width: sampling draws from the top
    # min(TOPK_CAP, vocab) logits of a lane
    TOPK_CAP = 64

    # failure flight recorder: expirations at one sweep that count as a
    # deadline storm, and the least wall seconds between two
    # auto-triggered bundles
    DEADLINE_STORM = 3
    POSTMORTEM_MIN_INTERVAL_S = 5.0

    def __init__(self, model, config: Optional[FFConfig] = None, *,
                 device="cuda", capture: bool = True,
                 faults: Optional[FaultInjector] = None,
                 telemetry: Optional[Telemetry] = None,
                 host_tier: Optional[HostPageStore] = None,
                 tensor_parallel: Optional[int] = None, mesh=None):
        self.device = resolve_device(device)
        if model.device != self.device and model.device.type != "cpu":
            raise ValueError(
                f"model lives on {model.device}, engine asked for "
                f"{self.device} (a model on the host serves from any "
                f"device)")
        # the engine's own CUDA stream: the wall-clock replica pool
        # steps each replica on its worker thread under on_stream(), so
        # replicas overlap on the card instead of serializing on the
        # default stream (None on the CPU)
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.arch = arch = arch_from_model(model)
        if model.state is None:
            model.compile(comp_mode=CompMode.INFERENCE)
        self.model = model
        # the block math over the model's parameter tensors: its live
        # ones, or the whole tensors gathered to the host from an
        # executing mesh's blocks (_serving_params); on the card or on
        # the host. The reference paths run it (_reference_lm)
        self.params = _serving_params(model)
        self.lm = TransformerLM(arch, self.params)
        self.config = cfg = config if config is not None else model.config
        self.vocab_size = arch.vocab
        self.max_positions = arch.max_positions
        self.num_layers = arch.num_layers
        self.num_heads = arch.num_heads
        self.head_dim = arch.head_dim
        self.act_dtype = arch.dtype
        self.hidden = arch.hidden
        self.ff_dim = arch.ff_dim
        # steady-state context the placement search prices at: 3/4 of
        # the serveable length (the JAX engine's max_seq_len default)
        self._max_seq_len = self.max_positions
        # the priced step of each pow2 context bucket (_drift_predicted)
        self._drift_cache: Dict[int, Optional[tuple]] = {}
        self._drift_mm = None
        self._resolve_serve_mesh(mesh, tensor_parallel)
        self.chunked_prefill = bool(cfg.serve_chunked_prefill)
        if self.tp > 1 and not self.chunked_prefill:
            raise ValueError(
                "sharded serving (serve_mesh / tensor_parallel > 1) "
                "shards the ONE mixed program; the legacy bucket-"
                "prefill path is single-device only")
        if self.tp > 1 and capture and self.bm.staging:
            raise ValueError(
                "a gloo tensor group on the card stages every "
                "collective through host memory, which a CUDA graph "
                "cannot capture: build the engine with capture=False "
                "(or give each rank a card of its own and NCCL)")
        self.cache_cfg = KVCacheConfig.from_ff(
            cfg, num_layers=self.num_layers, num_heads=self.num_heads,
            head_dim=self.head_dim, max_seq_len=self.max_positions,
            tensor_parallel=self.tp)
        self.cache_cfg.validate()
        self.prefix_cache = bool(cfg.serve_prefix_cache)
        self.prefill_budget = int(cfg.serve_prefill_budget)
        self.admit_watermark = float(cfg.serve_admit_watermark)
        self.degrade_ladder = bool(cfg.serve_degrade_ladder)
        self.reject_stalls = int(cfg.serve_reject_stalls)
        # robustness: the config-scoped injector (fault_spec) unless one
        # is given, bounded retry of transient dispatch faults,
        # per-request deadlines, and cancels swept at step boundaries
        self.faults = faults if faults is not None else injector_for(cfg)
        self.max_retries = int(cfg.serve_max_retries)
        self.retry_backoff = float(cfg.serve_retry_backoff_s)
        self.default_deadline = float(cfg.serve_request_deadline)
        self._retries = 0           # engine-lifetime retried dispatches
        self._cancels: set = set()  # rids cancel() marked
        self._active: Dict[int, Request] = {}
        # observability: the bus (the shared disabled one when off), its
        # tracks, the flight recorder, and the last run's requests for
        # explain_request (rids restart per run; trace ids do not)
        self.telemetry = telemetry if telemetry is not None \
            else telemetry_for(cfg)
        self.trace_out = cfg.trace_out
        self.set_track_process("serve")
        self.postmortem_dir = cfg.postmortem_dir
        self.postmortem_events = int(cfg.postmortem_events)
        self._postmortem_seq = 0
        self._postmortem_last = -float("inf")
        self._last_reqs: Dict[int, Request] = {}
        # speculation needs the mixed step (draft lanes are chunk lanes)
        spec = int(cfg.serve_spec_tokens) if cfg.serve_spec_decode else 0
        self.spec_tokens = spec if self.chunked_prefill else 0
        # page storage: f32 stores activations exactly; bf16 rounds on
        # write (exact when activations are already bf16); int8 and
        # float8_e4m3 quantize on write against per-page scale arrays.
        # kv_exact is the condition of the token-identity gate
        # (assert_token_parity)
        self.kv_dtype = self.cache_cfg.kv_dtype
        self.kv_quantized = self.cache_cfg.quantized
        self.kv_exact = (self.kv_dtype == "float32"
                         or self.cache_cfg.storage_dtype == self.act_dtype)
        # tie margin of the relaxed quantized parity gate: fp8's 3-bit
        # mantissa rounds ~8x coarser than int8's 127-step grid
        self.kv_tie_margin = 0.25 if self.kv_dtype == "float8_e4m3" \
            else 0.05
        if self.kv_quantized and not self.chunked_prefill:
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} needs the chunked mixed "
                f"program (quantize-on-write lives in the mixed step); "
                f"the legacy bucket-prefill path supports "
                f"float32/bfloat16")
        # the kernel's tuning knob (0 = kernel default); any value >= 0
        # serves (kernels/paged_ragged_v2.py _tile_for). The kernel maps
        # its tiles from the shapes it is called with, so at t > 1 it
        # sizes them for the rank's H/t heads (JAX's choose_block_kv is
        # called with heads_per_device for the same reason)
        self.attn_block_kv = int(cfg.serve_attn_block_kv)
        # the one mixed-step geometry: every prefill-budget token plus
        # one decode lane per slot always fits
        self.mixed_width = self.prefill_budget + self.cache_cfg.max_seqs
        self.topk_cap = min(self.TOPK_CAP, self.vocab_size)
        # persistent across generate() calls: the prefix cache only
        # pays off if committed pages outlive the batch that wrote them
        self.cache = PagedKVCache(self.cache_cfg,
                                  prefix_cache=self.prefix_cache)
        # the host-RAM tier (serve/host_tier.py) below the page pool: a
        # shared store (a replica pool's) wins, else host_tier_mb arms a
        # private one. It needs the prefix cache (a spilled page is
        # found again only through its chain key)
        self.host_tier = None
        if self.prefix_cache and self.chunked_prefill \
                and bool(cfg.serve_host_tier):
            if host_tier is not None:
                self.host_tier = host_tier
            elif float(cfg.host_tier_mb) > 0:
                self.host_tier = HostPageStore(float(cfg.host_tier_mb))
        self.cache.host_tier = self.host_tier
        self._host_mm = None       # machine model pricing the host copy
        self._host_reload_s = 0.0  # priced copy seconds, pending step
        self._host_reload_stats = {"reload_events": 0,
                                   "reload_pages": 0,
                                   "spilled_pages": 0,
                                   "recompute_chosen": 0,
                                   "reload_priced_s": 0.0}
        self._k_pages: Optional[torch.Tensor] = None
        self._v_pages: Optional[torch.Tensor] = None
        self._k_scales: Optional[torch.Tensor] = None
        self._v_scales: Optional[torch.Tensor] = None
        # page rows the export/import move: the page arrays, plus the
        # scale arrays of a quantized pool
        self._n_pools = 4 if self.kv_quantized else 2
        # multi-tenant LoRA adapters (serve/adapters.py): fixed
        # rank-padded slabs allocated once, slot 0 the zero slab of the
        # base model, armed by adapter_rank > 0
        self.adapters = None
        self.adapter_cfg = None
        self._adapter_slabs: Optional[Dict[str, torch.Tensor]] = None
        if int(cfg.adapter_rank) > 0:
            if not self.chunked_prefill:
                raise ValueError(
                    "adapter_rank > 0 needs the chunked mixed program "
                    "(the per-lane adapter gather lives in the mixed "
                    "step); the legacy bucket path serves base-only")
            # at the padded ff width and the degree: the B factors
            # split where their output is sharded, the A factors where
            # they contract a sharded dimension (_ADAPTER_SPLIT)
            self.adapter_cfg = AdapterConfig.from_ff(
                cfg, num_layers=self.num_layers, hidden=arch.hidden,
                num_heads=self.num_heads, head_dim=self.head_dim,
                ff_dim=self._ff_pad,
                act_itemsize=int(self.act_dtype.itemsize),
                tensor_parallel=self.tp)
            self.adapters = AdapterPool(self.adapter_cfg)
        # prompt-length buckets of the legacy prefill: powers of two
        # from one page up to the serveable length (the page-table
        # ceiling, capped at the positions the model learned)
        c = self.cache_cfg
        cap = min(c.pages_per_seq * c.page_size, c.max_seq_len)
        b = max(c.page_size, 16)
        self.buckets = []
        while b < cap:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(cap)
        # the mixed step's parameters and block math: at t > 1 the
        # rank's shards, cut from the whole tensors (on the host or the
        # card) and copied to the device (taken here, as the JAX
        # engine's _shard_params does at construction: a model trained
        # after this is served at t > 1 by a new engine); at t = 1 the
        # whole tensors, copied to the device once where they are not
        # there (a model on the card is served from its live tensors).
        # self.lm runs the one-device reference paths (generate_
        # reference, the tie rule's margin forward)
        self._lockstep = None
        if self.tp > 1:
            from ..models.transformer import ShardedLM
            from ..parallel.collectives import Lockstep
            from ..parallel.mesh import TENSOR
            self._step_params = self._shard_params()
            self.step_lm = ShardedLM(arch, self._step_params, self.bm,
                                     TENSOR)
            self._lockstep = Lockstep(self.bm, TENSOR)
        else:
            self._step_params = self._on_device(self.params)
            self.step_lm = self.lm \
                if self._step_params is self.params \
                else TransformerLM(arch, self._step_params)
        # at most ONE live ServeSession owns the scheduler/slots
        self._session: Optional["ServeSession"] = None
        self.boot_stats: Optional[dict] = None
        self.last_stats: Optional[dict] = None
        # the serving programs, in the JAX engine's families; with
        # program_cache_dir the kernel-library cache is armed and the
        # store of this fingerprint's signatures read back (the warm
        # boot: warmup() captures every one of them)
        self.programs = ProgramRegistry(
            self._program_fingerprint(), self.device, capture=capture,
            cache_dir=cfg.program_cache_dir)
        # the JAX engine's six families: the serving steps, the adapter
        # slot load and the page export/import (run eagerly and counted)
        for fam in ("prefill", "decode", "mixed", "adapter", "export",
                    "import"):
            self.programs.register(fam)
        self.programs_restored = self.programs.load_warm()
        self._stage_in = PinnedRing(self.device)
        self._stage_out = PinnedRing(self.device)
        # the /metrics and /healthz endpoint, started LAST so that a
        # failure above leaks no bound port or thread; close() stops it
        self.metrics_server = None
        if cfg.metrics_port is not None:
            self.metrics_server = MetricsServer(
                self.telemetry.to_prometheus, port=int(cfg.metrics_port),
                host=str(cfg.metrics_host))

    def _kernel_sources(self) -> Tuple[str, ...]:
        """The CUDA sources of the active path's kernels."""
        return ("paged_ragged_v2",) if self.chunked_prefill \
            else ("paged_decode",)

    def _program_fingerprint(self) -> dict:
        """The identity of this engine's programs: everything that shapes
        or numbers a serving step — the JAX engine's keys (its ``jax``
        version is ``torch`` here, ``use_pallas`` the digests of the
        path's kernel sources, ``interpret`` the backend), the CUDA
        version and the device's name. Flipping any of them misses the
        program store; an edited kernel source does too."""
        c = self.cache_cfg
        ac = self.adapter_cfg
        from ..kernels import _build
        return {"kind": "serve",
                **runtime_identity(self.device),
                "backend": self.device.type, "devices": self.tp,
                "device": str(self.device),
                "arch": {k: str(v) for k, v in
                         dataclasses.asdict(self.arch).items()},
                "num_layers": self.num_layers, "hidden": self.hidden,
                "num_heads": self.num_heads, "head_dim": self.head_dim,
                "ff_pad": self._ff_pad, "vocab": self.vocab_size,
                "max_positions": self.max_positions,
                "layer_norm": bool(self.arch.layer_norm),
                "act_dtype": str(self.act_dtype),
                "max_seq_len": self._max_seq_len,
                "chunked_prefill": self.chunked_prefill,
                "prefill_budget": self.prefill_budget,
                "mixed_width": self.mixed_width, "topk_cap": self.topk_cap,
                "buckets": tuple(self.buckets), "kv_dtype": self.kv_dtype,
                "kv_store_dtype": str(c.storage_dtype),
                "page_size": c.page_size, "pages_per_seq": c.pages_per_seq,
                "num_pages": c.num_pages, "max_seqs": c.max_seqs,
                "attn_block_kv": self.attn_block_kv,
                "adapter_rank": 0 if ac is None else ac.rank,
                "adapter_slots": 0 if ac is None else ac.num_slots,
                "tp": self.tp,
                "kernels": {n: _build.source_digest(n)
                            for n in self._kernel_sources()}}

    def compile_counts(self) -> dict:
        """Captured programs per serving family (on the CPU and with
        capture off: distinct step signatures). After warmup() these
        must never grow — the zero-recompile serving contract."""
        return self.programs.compile_counts()

    def close(self) -> None:
        """Stop the /metrics endpoint and release the captured graphs
        (each holds a private memory pool). Idempotent; the engine
        still serves after it, capturing its programs anew."""
        server, self.metrics_server = self.metrics_server, None
        if server is not None:
            server.close()
        self.programs.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def on_stream(self):
        """Context that makes this engine's own stream current (a no-op
        on the CPU): staging copies, replays, event records and the
        step's synchronize then stay on it."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # ---------------- placement -----------------------------------------
    def _resolve_serve_mesh(self, mesh, tensor_parallel) -> None:
        """Resolve (tp, tp_mesh, bm), JAX's precedence: an explicit
        ``mesh`` (a MeshShape with a ``tensor`` axis) or
        ``tensor_parallel`` wins; otherwise FFConfig.serve_mesh: "" one
        device, "N" degree N, "auto" the placement search over
        ``parallel.mesh.serve_devices()`` (the process group's world
        size, else the visible cards). num_heads must divide by the
        degree; ff and vocab are padded to a multiple of it. A degree
        above 1 binds the mesh to the running process group, which must
        have exactly that many ranks."""
        from ..parallel.mesh import TENSOR, serve_devices, \
            serve_tensor_mesh
        cfg = self.config
        self.serve_placement = None
        if mesh is None and tensor_parallel is None:
            sm = str(cfg.serve_mesh or "").strip()
            if sm == "auto":
                from ..search.serve_place import optimize_serve
                arch = self.serve_arch()
                # a degree above 1 holds the model's own parameters on
                # its card beside its shards when the model lives there
                # (none of a model on the host): the memory penalty sees
                # them
                place = optimize_serve(
                    arch, serve_devices(), config=cfg,
                    resident_bytes=card_param_bytes(self.model,
                                                    self.device))
                self.serve_placement = place
                tensor_parallel = place.tensor_parallel
            elif sm:
                tensor_parallel = int(sm)
        self.tp = 1
        self.tp_mesh = None
        if mesh is not None:
            if TENSOR not in mesh.shape:
                raise ValueError(
                    f"serve mesh needs a {TENSOR!r} axis, got "
                    f"{dict(mesh.shape)}")
            self.tp = int(mesh.shape[TENSOR])
            self.tp_mesh = mesh if self.tp > 1 else None
        elif tensor_parallel is not None and int(tensor_parallel) > 1:
            self.tp = int(tensor_parallel)
            self.tp_mesh = serve_tensor_mesh(self.tp)
        if self.tp > 1 and self.num_heads % self.tp != 0:
            raise ValueError(
                f"sharded serving needs num_heads ({self.num_heads}) "
                f"divisible by the tensor degree ({self.tp})")
        # ff/vocab need not divide: their shards pad (zero ff columns
        # contribute exact zeros; pad vocab columns carry a -1e30 bias
        # so they never win argmax or enter the top-k)
        self._ff_pad = -(-self.ff_dim // self.tp) * self.tp
        self._vocab_pad = -(-self.vocab_size // self.tp) * self.tp
        self.bm = None
        if self.tp_mesh is not None:
            try:
                self.bm = self.tp_mesh.bind()
            except RuntimeError as e:
                raise RuntimeError(
                    f"tensor-parallel serving at degree {self.tp} runs "
                    f"one engine on each rank of a process group of "
                    f"{self.tp_mesh.size} ranks "
                    f"(parallel.mesh.init_distributed on every rank): "
                    f"{e}") from e

    def _shard_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """This rank's blocks of the LM parameters (JAX's
        ``_shard_params``, whose PartitionSpecs each line names), cut
        from the whole tensors where they live (the host or the card)
        and copied to the engine's device:

          wq/wk/wv (E, H, D)  -> heads column-parallel
          wo       (H, D, E)  -> heads row-parallel (all-reduce after)
          ff1      (E, F)     -> column-parallel (+ bias block), padded
          ff2      (F, E)     -> row-parallel (all-reduce before bias)
          lm_head  (E, V)     -> vocab column-parallel (all-gather at
                                 the logits; pad columns biased -1e30,
                                 a bias made up when the head has none)
          tok_embed (V, E)    -> vocab row-parallel (masked local
                                 gather + exact all-reduce)
          everything else     -> replicated (LNs, pos_embed, biases)"""
        from ..parallel.mesh import TENSOR
        t, c = self.tp, self.bm.coord(TENSOR)

        def pad_to(a, axis, size, value=0.0):
            extra = size - a.shape[axis]
            if extra <= 0:
                return a
            shape = list(a.shape)
            shape[axis] = extra
            return torch.cat([a, torch.full(shape, value, dtype=a.dtype,
                                             device=a.device)], dim=axis)

        def block(a, axis):
            n = a.shape[axis] // t
            return a.narrow(axis, c * n, n)

        vp, fp = self._vocab_pad, self._ff_pad
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, p in self.params.items():
            o = {}
            for key, arr in p.items():
                a = arr.detach()
                if name == "tok_embed" and key == "kernel":
                    a = block(pad_to(a, 0, vp), 0)
                elif name.endswith("_attn") and key in ("wq", "wk", "wv"):
                    a = block(a, 1)
                elif name.endswith("_attn") and key == "wo":
                    a = block(a, 0)
                elif name.endswith("_ff1") and key == "kernel":
                    a = block(pad_to(a, 1, fp), 1)
                elif name.endswith("_ff1") and key == "bias":
                    a = block(pad_to(a, 0, fp), 0)
                elif name.endswith("_ff2") and key == "kernel":
                    a = block(pad_to(a, 0, fp), 0)
                elif name == "lm_head" and key == "kernel":
                    a = block(pad_to(a, 1, vp), 1)
                elif name == "lm_head" and key == "bias":
                    a = block(pad_to(a, 0, vp, _PAD_LOGIT_BIAS), 0)
                o[key] = a.to(self.device, copy=True,
                              memory_format=torch.contiguous_format)
            if name == "lm_head" and "bias" not in p \
                    and vp > self.vocab_size:
                # padded vocab columns must never win argmax: make up a
                # bias (+0.0 on real columns is exact)
                b = torch.zeros((vp,), dtype=self.act_dtype,
                                device=self.device)
                b[self.vocab_size:] = _PAD_LOGIT_BIAS
                o["bias"] = block(b, 0).clone()
            out[name] = o
        return out

    def _on_device(self, params):
        """``params`` with every tensor that is not on the engine's
        device copied there (the same dict where all are)."""
        if all(_on_card(t, self.device) for p in params.values()
               for t in p.values()):
            return params
        with torch.no_grad():
            return {op: {k: t if _on_card(t, self.device) else
                         t.detach().to(self.device, copy=True)
                         for k, t in p.items()}
                    for op, p in params.items()}

    @contextlib.contextmanager
    def _reference_lm(self):
        """The one-device LM the reference paths run, on the device:
        ``self.lm`` where its parameters are there (a model on the card,
        or at t = 1 the step's own copy of them), else a copy of its
        parameters on the device for the call only, freed on exit. The
        reference's GEMMs run on the card either way, so the tie rule's
        margins are the same; a copy that does not fit raises the
        device's out-of-memory error."""
        lm = self.lm
        if self.tp == 1 and lm.params is self.params:
            lm = self.step_lm
        params = self._on_device(lm.params)
        yield lm if params is lm.params else TransformerLM(lm.arch, params)
        del params

    def _card_model_params(self) -> List[torch.Tensor]:
        """The model's own parameter tensors on the engine's device
        that the step does not read: what the card holds beside the
        step's parameters (at t > 1 the model's tensors when it lives
        on the card; none of a model on the host, nor at t = 1 where
        the step reads the model's live tensors)."""
        step = {id(t) for p in self._step_params.values()
                for t in p.values()}
        return [t for p in self.model.state.params.values()
                for t in p.values()
                if _on_card(t, self.device) and id(t) not in step]

    def _sharding_stats(self) -> Optional[dict]:
        """The last_stats/serve_report sharding block (JAX's): mesh
        shape, heads per device, per-device KV pool bytes, and the
        analytic per-step collective payload (2 all-reduces of the lane
        activations per layer + the embedding all-reduce + the final
        logits all-gather). None on one device."""
        if self.tp <= 1:
            return None
        c = self.cache_cfg
        T = self.mixed_width
        act = int(self.act_dtype.itemsize)
        coll = ((2 * self.num_layers + 1) * T * self.hidden * act
                + T * self._vocab_pad * act)
        return {
            "mesh": {"tensor": self.tp},
            "tensor_parallel": self.tp,
            "heads_per_device": self.num_heads // self.tp,
            "kv_pool_device_bytes": int(c.pool_device_bytes),
            "collective_bytes_per_step": int(coll),
        }

    def serve_arch(self, context: Optional[int] = None):
        """The ServeArch the placement search prices for this engine's
        model and serving knobs (search/cost_model.serve_step_tasks):
        decode lanes = the slot reserve, prefill lanes = the budget,
        steady-state context defaulting to 3/4 of the serveable length,
        KV traffic at the page format's itemsize — the JAX engine's
        fields, value for value."""
        acfg = getattr(self, "adapter_cfg", None)
        if acfg is None and int(self.config.adapter_rank) > 0:
            acfg = AdapterConfig.from_ff(
                self.config, num_layers=self.num_layers,
                hidden=self.hidden, num_heads=self.num_heads,
                head_dim=self.head_dim, ff_dim=self.ff_dim,
                act_itemsize=int(self.act_dtype.itemsize))
        return _serve_arch(self.arch, self.config, acfg,
                           context if context is not None
                           else max(1, self._max_seq_len * 3 // 4))

    # ---------------- device pages and the mixed step ------------------
    def _device_pages(self):
        """The page pool (and scale arrays) on the device, allocated at
        the first call; so are the adapter slabs, so that every tensor
        a captured step reads exists before its first dispatch."""
        if self._k_pages is None:
            self._k_pages, self._v_pages = \
                self.cache.alloc_device_cache(self.device)
        if self.kv_quantized and self._k_scales is None:
            self._k_scales, self._v_scales = \
                self.cache.alloc_scale_arrays(self.device)
            self.cache.register_scale_meta(self._k_scales, self._v_scales)
        self._device_adapters()
        return self._k_pages, self._v_pages

    # ---------------- adapter pool: device half -----------------------
    def _adapter_row_shapes(self) -> Dict[str, tuple]:
        """{slab: one tenant's host rows}: adapters._weight_shapes at
        the pool's rank, (L, ...) a factor, plus the () scale."""
        from .adapters import _weight_shapes
        ac = self.adapter_cfg
        shapes = dict(_weight_shapes(ac, ac.rank, ac.ff_dim))
        shapes["scale"] = ()
        return shapes

    def _adapter_slab_shapes(self) -> Dict[str, tuple]:
        """{slab: device shape}: each factor (L, num_slots, ...) — layer
        first, so that a layer's slab is one contiguous block the
        per-lane gather indexes along its slots (JAX stacks slots first
        and gathers every layer at once: the same values) — and the
        (num_slots,) f32 per-slot scale; at t > 1 the rank's block of
        each split slab (_ADAPTER_SPLIT)."""
        s = self.adapter_cfg.num_slots
        out = {}
        for k, sh in self._adapter_row_shapes().items():
            sh = list(sh)
            if k in _ADAPTER_SPLIT:
                sh[_ADAPTER_SPLIT[k]] //= self.tp
            out[k] = (sh[0], s) + tuple(sh[1:]) if sh else (s,)
        return out

    def _adapter_rows_local(self, key: str, rows: np.ndarray) -> np.ndarray:
        """This rank's block of one tenant's rows of slab ``key`` (the
        rows themselves on one device)."""
        d = _ADAPTER_SPLIT.get(key)
        if self.tp <= 1 or d is None:
            return rows
        from ..parallel.mesh import TENSOR
        n = rows.shape[d] // self.tp
        return np.take(rows, range(self.bm.coord(TENSOR) * n,
                                   (self.bm.coord(TENSOR) + 1) * n),
                       axis=d)

    def _device_adapters(self) -> Optional[Dict[str, torch.Tensor]]:
        """The resident slabs, allocated once (lazily, like the pages):
        A/B factors at the activation dtype, per-slot scales f32, all
        zeros until tenants load — so slot 0 stays the zero slab of the
        base model (nothing ever writes it). Loads copy into them in
        place, so the tensors a captured mixed step reads never
        move."""
        if self.adapters is None:
            return None
        if self._adapter_slabs is None:
            self._adapter_slabs = {
                key: torch.zeros(shape, device=self.device,
                                 dtype=(torch.float32 if key == "scale"
                                        else self.act_dtype))
                for key, shape in self._adapter_slab_shapes().items()}
        return self._adapter_slabs

    def _adapter_load(self, slot: int, rows: Dict[str, np.ndarray]) -> None:
        """Copy one tenant's host rows (f32; cast to the slab dtype as
        JAX's ``.astype`` does) into ``slot`` of every slab, in place,
        counted as the ``adapter`` family (one signature: every (slot,
        tenant) load is the same program)."""
        slabs = self._device_adapters()

        def load(slot_t, *tensors):
            slot = int(slot_t)
            for key, t in zip(sorted(rows), tensors):
                dst = slabs[key][slot] if key == "scale" \
                    else slabs[key][:, slot]
                dst.copy_(t, non_blocking=True)
        self._fire_with_retry("serve.adapter")
        self.programs.call_eager(
            "adapter", load, torch.tensor(slot, dtype=torch.int32),
            *(torch.from_numpy(self._adapter_rows_local(
                k, np.asarray(rows[k], np.float32)))
              for k in sorted(rows)))

    def register_adapter(self, tenant_id: int, weights, *,
                         scale: float = 1.0) -> None:
        """Register a tenant's LoRA weights with the pool (a host copy;
        the device load happens on demand at admission). ``weights`` is
        the adapters.ADAPTER_SLABS dict at the model's ff width and any
        rank <= the pool rank (zero-padded: exact)."""
        if self.adapters is None:
            raise RuntimeError(
                "engine has no adapter pool (set adapter_rank > 0)")
        self.adapters.register(tenant_id, weights, scale=scale,
                               ff_dim=self.arch.ff_dim)

    def adapter_resident(self, tenant_id: int) -> bool:
        """Whether a tenant's adapter holds a slab slot — the router's
        adapter-affinity signal."""
        return self.adapters is not None \
            and self.adapters.resident(tenant_id)

    def _drain_adapter_loads(self) -> int:
        """Load every pending tenant into its slot — the session calls
        this BEFORE each mixed dispatch, so no lane gathers a slot its
        tenant has not landed in. Returns the loads made (a stall the
        plan sees, never a new capture)."""
        if self.adapters is None:
            return 0
        pending = self.adapters.take_pending()
        for slot, tenant in pending:
            w, sc = self.adapters.host_weights(tenant)
            rows = dict(w)
            rows["scale"] = np.float32(sc)
            self._adapter_load(slot, rows)
            if self.telemetry.enabled:
                self.telemetry.instant(
                    self._ENGINE_TRACK, "adapter_load",
                    args={"tenant": tenant, "slot": slot})
        return len(pending)

    # ---------------- page export and import --------------------------
    # Whole page rows — (layers, page, offset, head[, dim]) blocks of the
    # pool tensors, and of the scale tensors on quantized pools — move
    # between the pool and host numpy, the page-index vector padded to
    # pages_per_seq with the sink page 0 (one signature per family). The
    # host layout is the JAX engine's byte for byte; bf16 and fp8 rows
    # travel as uint16 and uint8 views.
    _HOST_VIEW = {torch.bfloat16: (torch.int16, np.uint16),
                  torch.float8_e4m3fn: (torch.uint8, np.uint8)}

    def _pool_args(self) -> tuple:
        args = (self._k_pages, self._v_pages)
        if self.kv_quantized:
            args += (self._k_scales, self._v_scales)
        return args

    def _pad_idx(self, pages: Sequence[int]) -> np.ndarray:
        c = self.cache_cfg
        if len(pages) > c.pages_per_seq:
            raise ValueError(
                f"shipment of {len(pages)} pages exceeds this pool's "
                f"page-table ceiling ({c.pages_per_seq})")
        idx = np.zeros((c.pages_per_seq,), np.int32)
        idx[:len(pages)] = pages
        return idx

    def _export_rows(self, idx: np.ndarray) -> List[np.ndarray]:
        """Gather the page rows at ``idx`` of every pool tensor to host
        numpy (counted as ``export``): (L, len(idx), ps, H[, D]). At
        t > 1 each rank gathers its heads and one all-gather on the head
        axis assembles whole rows, the one-device layout, on every rank
        (JAX's ``_export_tp_impl`` returns the same global rows)."""
        self._device_pages()
        self._fire_with_retry("serve.export")

        def gather(i, *pools):
            from ..parallel.collectives import gather_tensor
            from ..parallel.mesh import TENSOR
            i = i.to(self.device).long()
            out = []
            for pool in pools:
                rows = pool.index_select(1, i)
                view = self._HOST_VIEW.get(rows.dtype)
                if view is not None:
                    rows = rows.view(view[0])
                if self.tp > 1:
                    rows = gather_tensor(rows, self.bm, TENSOR, dim=3)
                rows = rows.cpu().numpy()
                out.append(rows.view(view[1]) if view is not None
                           else rows)
            return out
        return self.programs.call_eager(
            "export", gather, torch.from_numpy(idx), *self._pool_args())

    def _import_rows(self, idx: np.ndarray,
                     rows: Sequence[np.ndarray]) -> None:
        """Scatter host page rows into the pool tensors at ``idx``, in
        place (counted as ``import``): the tensors a captured mixed step
        reads never move. Padding entries write their zero rows into the
        sink page (never read unmasked). ``rows`` are whole rows, the
        one-device layout; at t > 1 each rank keeps its heads (no
        collective: every rank holds the same rows)."""
        self._device_pages()
        self._fire_with_retry("serve.import")
        if self.tp > 1:
            from ..parallel.mesh import TENSOR
            h = self.cache_cfg.heads_per_device
            lo = self.bm.coord(TENSOR) * h
            rows = [r[:, :, :, lo:lo + h] for r in rows]

        def scatter(i, *src):
            i = i.to(self.device).long()
            for pool, r in zip(self._pool_args(), src):
                t = r.to(self.device, non_blocking=True)
                if pool.element_size() == 1:
                    pool.view(torch.uint8).index_copy_(
                        1, i, t.view(torch.uint8))
                else:
                    pool.index_copy_(1, i, t.view(pool.dtype))
        # numpy's uint16 (bf16 rows) enters torch as int16: the pool's
        # view then reinterprets the same bits
        self.programs.call_eager(
            "import", scatter, torch.from_numpy(idx),
            *(torch.from_numpy(np.ascontiguousarray(
                r.view(np.int16) if r.dtype == np.uint16 else r))
              for r in rows))

    def export_kv(self, slot: int, tokens: Sequence[int],
                  stream_id: Optional[int] = None,
                  trace_id: Optional[int] = None,
                  tenant_id: int = 0) -> Optional[PageShipment]:
        """Ship ``slot``'s full resident pages to the host: the prefill
        half of a disaggregated handoff. Returns a PageShipment (the
        chain keys, the page rows and scale rows as host numpy, the
        geometry stamp), or None when the slot has no full page yet.
        Must run while the slot is still mapped (from generate()'s
        ``on_finish``)."""
        from .disagg import PageShipment
        pages, keys, ntokens = self.cache.export_pages(
            slot, tokens, prev=tenant_prefix_salt(tenant_id))
        if not pages:
            return None
        n = len(pages)
        # copy the real pages' slice: a view would pin the whole padded
        # gather for the shipment's life
        host = [r[:, :n].copy()
                for r in self._export_rows(self._pad_idx(pages))]
        c = self.cache_cfg
        return PageShipment(
            keys=list(keys), ntokens=int(ntokens),
            k_rows=host[0], v_rows=host[1],
            k_scale_rows=host[2] if self.kv_quantized else None,
            v_scale_rows=host[3] if self.kv_quantized else None,
            page_size=c.page_size, num_layers=c.num_layers,
            num_heads=c.num_heads, head_dim=c.head_dim,
            kv_dtype=c.kv_dtype, stream_id=stream_id,
            trace_id=trace_id, tenant_id=int(tenant_id))

    def import_kv(self, ship: PageShipment) -> int:
        """Adopt a PageShipment into this pool: the decode half of a
        handoff. Registers the chain keys (already-resident keys dedupe
        to nothing) and writes the needed rows into freshly parked
        pages, so the next admission prefix-matches the prompt as if it
        had been computed here. Returns the pages written (0 = full
        dedupe); the caller checks ``cache.free_pages`` first."""
        c = self.cache_cfg
        if (ship.page_size, ship.num_layers, ship.num_heads,
                ship.head_dim, ship.kv_dtype) != (
                c.page_size, c.num_layers, c.num_heads, c.head_dim,
                c.kv_dtype):
            raise ValueError(
                f"shipment geometry {ship.signature()} does not match "
                f"this pool ({(c.page_size, c.num_layers, c.num_heads, c.head_dim, c.kv_dtype)})")
        todo = self.cache.import_pages(ship.keys)
        if not todo:
            return 0
        idx = self._pad_idx([page for _, page in todo])
        srcs = [ship.k_rows, ship.v_rows]
        if self.kv_quantized:
            srcs += [ship.k_scale_rows, ship.v_scale_rows]
        rows = []
        for src in srcs:
            buf = np.zeros((src.shape[0], c.pages_per_seq)
                           + src.shape[2:], src.dtype)
            for j, (chain_i, _) in enumerate(todo):
                buf[:, j] = src[:, chain_i]
            rows.append(buf)
        self._import_rows(idx, rows)
        return len(todo)

    def _host_row_shapes(self) -> List[tuple]:
        """(shape, numpy dtype) of each pool's padded export rows."""
        c = self.cache_cfg
        val = (c.num_layers, c.pages_per_seq, c.page_size, c.num_heads,
               c.head_dim)
        dt = self.cache_cfg.storage_dtype
        view = self._HOST_VIEW.get(dt)
        npdt = view[1] if view is not None else \
            torch.empty((), dtype=dt).numpy().dtype
        shapes = [(val, npdt), (val, npdt)]
        if self.kv_quantized:
            shapes += [(val[:-1], np.float32), (val[:-1], np.float32)]
        return shapes

    def warmup_handoff(self) -> Dict[str, int]:
        """Run the export and import once on sink-page dummies (a no-op
        on the pool's content), so no handoff or host-tier traffic
        counts a new program after warmup. Returns compile_counts()."""
        idx = np.zeros((self.cache_cfg.pages_per_seq,), np.int32)
        self._export_rows(idx)
        self._import_rows(idx, [np.zeros(sh, dt)
                                for sh, dt in self._host_row_shapes()])
        return self.compile_counts()

    # ---------------- the host tier ------------------------------------
    def _drain_spills(self) -> int:
        """Ship queued evicted-page content to the host tier through the
        export. MUST run before any dispatch that writes the pool: a
        queued page may already be remapped to a new slot, and its old
        rows survive only until the next write. The session calls this
        right before each mixed dispatch; a reload drains before its
        import for the same reason."""
        store = self.host_tier
        if store is None:
            return 0
        pending = self.cache.take_pending_spills()
        if not pending:
            return 0
        latest = {}          # a page queued twice keeps its newest key
        for page, key in pending:
            latest[page] = key
        todo = [(p, k) for p, k in latest.items()
                if not store.contains(k)]
        if not todo:
            return 0
        c = self.cache_cfg
        shipped = 0
        for i in range(0, len(todo), c.pages_per_seq):
            batch = todo[i:i + c.pages_per_seq]
            host = self._export_rows(self._pad_idx([p for p, _ in batch]))
            for j, (_, key) in enumerate(batch):
                if store.put(key, [h[:, j] for h in host]):
                    shipped += 1
        self._host_reload_stats["spilled_pages"] += shipped
        if self.telemetry.enabled and shipped:
            self.telemetry.instant(self._ENGINE_TRACK, "host_spill",
                                   args={"pages": shipped})
        return shipped

    def _host_step_price(self, ctx_len: int) -> float:
        """Predicted seconds of ONE mixed step at this context — the
        recompute side of the spill-vs-recompute decision, from the cost
        stack the drift calibrator prices, else the analytic fallback
        the router's virtual clock uses (JAX's formula)."""
        pred = self._drift_predicted(pow2_bucket(max(1, ctx_len)))
        if pred is not None:
            return float(pred[0])
        return 1e-4 * (1.0 + self.mixed_width / 512.0) \
            * (1.0 + ctx_len / 2048.0)

    def _host_reload(self, req, keys, cached_pages,
                     max_pages: int) -> int:
        """The scheduler's admission hook when the host tier is armed:
        extend a device prefix match with host-resident pages IF the
        priced copy (the machine model's ``host_transfer``) beats
        recomputing those tokens (steps times the step price). Reloaded
        pages park like an import (hashed, refcount 0), so the
        scheduler's re-match picks them up; ``free_pages`` is unchanged
        (free -> parked). Returns the pages made resident; the decision
        is recorded on the request either way (explain_request)."""
        store, cache = self.host_tier, self.cache
        resident = len(cached_pages)
        run = cache.match_prefix_host(keys, resident)
        if run <= 0:
            return 0
        c = self.cache_cfg
        m = min(run, int(max_pages))
        decision = {"host_matched_pages": int(run),
                    "reloaded_pages": 0, "dma_s": 0.0,
                    "recompute_s": 0.0, "chose": "none"}
        req.host_reload = decision
        if m <= 0:
            return 0
        if self._host_mm is None:
            from ..search.machine_model import default_machine_model
            self._host_mm = default_machine_model()
        dma_s = float(self._host_mm.host_transfer(
            float(m) * float(c.page_bytes)))
        steps = -(-(m * c.page_size) // max(1, self.prefill_budget))
        recompute_s = steps * self._host_step_price(len(req.prompt))
        decision.update(dma_s=dma_s, recompute_s=recompute_s)
        if dma_s >= recompute_s:
            decision["chose"] = "recompute"
            self._host_reload_stats["recompute_chosen"] += 1
            return 0
        # protect the device-matched refcount-0 run from the import's
        # eviction cascade (allocation evicts the LRU-oldest)
        cache.touch(cached_pages)
        t0 = time.perf_counter()
        # fetch rows FIRST: on a shared store another replica's puts may
        # have evicted part of the matched run since the probe
        fetched = []
        for key in keys[resident:resident + m]:
            rows = store.get(key)
            if rows is None:
                break
            fetched.append(rows)
        val_shape = (c.num_layers, c.page_size, c.num_heads, c.head_dim)
        if not fetched or tuple(fetched[0][0].shape) != val_shape:
            decision["chose"] = "store_miss"  # raced away / foreign
            return 0                          # geometry: never scatter
        todo = cache.import_pages(keys[resident:resident + len(fetched)])
        if not todo:
            decision["chose"] = "store_miss"
            return 0
        # the allocation above may have queued evictions of its own:
        # their content must ship before the import overwrites it
        self._drain_spills()
        idx = self._pad_idx([page for _, page in todo])
        rows = []
        for pool_i in range(self._n_pools):
            src0 = fetched[0][pool_i]
            buf = np.zeros((src0.shape[0], c.pages_per_seq)
                           + src0.shape[1:], src0.dtype)
            for j, (chain_i, _) in enumerate(todo):
                buf[:, j] = fetched[chain_i][pool_i]
            rows.append(buf)
        self._import_rows(idx, rows)
        n = len(todo)
        decision.update(chose="reload", reloaded_pages=n)
        self._host_reload_stats["reload_events"] += 1
        self._host_reload_stats["reload_pages"] += n
        self._host_reload_stats["reload_priced_s"] += dma_s
        self._host_reload_s += dma_s
        if self.telemetry.enabled:
            self.telemetry.span(
                self._ENGINE_TRACK, "host_reload", t0,
                time.perf_counter(),
                args={"trace": req.trace_id, "rid": req.rid,
                      "pages": n, "dma_s": dma_s})
        return n

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds the largest bucket "
            f"{self.buckets[-1]}")

    def _write_kv(self, i, where, k, v):
        """Scatter layer i's K/V rows into the pages at ``where`` =
        (page, offset) index tensors, IN PLACE (index_put_), where the
        JAX engine donates the pages to the jitted step and gets them
        back: a torch tensor is mutable, so the pool never exists
        twice. Quantized pools write each row's codes and its f32
        scale; the 1-byte codes go through uint8 views of the pages
        (index_put_ is not implemented for every 1-byte type on every
        device). Duplicate indices (inactive lanes all aim at the sink
        page 0, offset 0) race harmlessly: no lane reads the sink
        unmasked."""
        kp, vp = self._k_pages, self._v_pages
        if not self.kv_quantized:
            kp[i].index_put_(where, k.to(kp.dtype))
            vp[i].index_put_(where, v.to(vp.dtype))
            return
        for pages, scales, x in ((kp, self._k_scales, k),
                                 (vp, self._v_scales, v)):
            codes, sc = quantize_kv_rows(x, pages.dtype)
            pages[i].view(torch.uint8).index_put_(
                where, codes.view(torch.uint8))
            scales[i].index_put_(where, sc)

    def _greedy_topk(self, x, lm):
        """Logits of the final hidden rows x (N, E) through ``lm``'s
        head, reduced on the device to (greedy (N,) int32, top-k values
        (N, K) f32, top-k ids (N, K) int32). argmax returns the FIRST
        maximum, as jnp.argmax does (the parity contract with
        generate_reference). At t > 1 the logits are the all-gathered
        (N, vocab_pad) columns, the pad columns at -1e30."""
        logits = lm.head(x)                                 # (N, V)
        topv, topi = torch.topk(logits, self.topk_cap, dim=-1)
        return (torch.argmax(logits, dim=-1).to(torch.int32),
                topv.float(), topi.to(torch.int32))

    def mixed_step_cost_analysis(self) -> dict:
        """The cost of one mixed step at the engine's fixed geometry, on
        warmup's sink-page inputs: ``flops`` and ``bytes accessed`` as
        the JAX engine's dict has them, plus the breakdown of
        ``utils/profiling.StepCost`` (kernel 1's count from its launch
        arguments, its share of the whole). At t > 1 the rank's step
        (every rank calls it: the step's collectives run). The step runs
        once eagerly on copies of the pages and scales, never as a
        captured replay: the pages, ``compile_counts()``, the kernels'
        launch counts and the captured graphs are as they were. Call it
        outside timed regions."""
        from ..utils.profiling import StepCost, untraced
        c = self.cache_cfg
        self._device_pages()
        t = self.mixed_width
        z = np.zeros((t,), np.int32)
        arrays = [z, z, z, z, np.zeros((c.max_seqs, c.pages_per_seq),
                                       np.int32), z, np.ones((t,), np.int32)]
        if self.adapters is not None:
            arrays.append(z)
        lanes = [torch.from_numpy(a).to(self.device) for a in arrays]
        pools = ("_k_pages", "_v_pages", "_k_scales", "_v_scales")
        saved = {n: getattr(self, n) for n in pools}
        for n, x in saved.items():
            setattr(self, n, None if x is None else x.clone())
        try:
            with untraced(self.device), StepCost() as cost, \
                    self.on_stream():
                self._mixed_body(*lanes)
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
        finally:
            for n, x in saved.items():
                setattr(self, n, x)
        return cost.result()

    @torch.no_grad()
    def _mixed_body(self, tokens, positions, write_pages, write_offs,
                    page_tables, lane_slots, lane_lens,
                    lane_adapters=None):
        """ONE serving step over `mixed_width` lanes (all (T,) int32 on
        the device, host-built): the token to embed, its position, the
        physical (page, offset) its K/V lands in (inactive lanes aim at
        the sink page 0), the page-table row it reads and its visible
        length (position + 1; inactive lanes 1, so the masked softmax
        stays NaN-free), and on an adapter-armed engine its adapter
        slot (0: the zero slab of the base model). Returns (greedy (T,)
        int32, top-k values (T, K) f32, top-k ids (T, K) int32). At
        t > 1 the same body runs on every rank over its shards and its
        heads of the pages (``ShardedLM``)."""
        m = self.step_lm
        kp, vp = self._device_pages()
        ks, vs = self._k_scales, self._v_scales
        x = m.embed(tokens, positions)                      # (T, E)
        scale = 1.0 / math.sqrt(self.head_dim)
        where = (write_pages.long(), write_offs.long())
        slabs = la = ad_s = None
        if lane_adapters is not None:
            # each lane's slot rows, gathered per layer from the layer's
            # contiguous slab (the JAX engine gathers the whole stack
            # once and slices per layer: the same values, a sixth of the
            # transient memory here)
            slabs = self._device_adapters()
            la = lane_adapters.long()
            ad_s = slabs["scale"].index_select(0, la)       # (T,)
        for i in range(self.num_layers):
            lora = None if slabs is None else {
                key: slabs[key][i].index_select(0, la)
                for key in ("a_qkv", "b_qkv", "a_wo", "b_wo", "a_ff1",
                            "b_ff1", "a_ff2", "b_ff2")}
            q, k, v = m.attn_qkv(
                i, m.attn_in(i, x), lora=None if lora is None else
                (lora["a_qkv"], lora["b_qkv"], ad_s))       # (T, H, D)
            # every lane's row lands (quantized, on int8/fp8 pools)
            # BEFORE any lane attends, so what a lane reads back this
            # very step is already the stored value
            self._write_kv(i, where, k, v)
            o = paged_attention_ragged(
                q, kp[i], vp[i], page_tables, lane_slots, lane_lens,
                scale=scale, block_kv=self.attn_block_kv or None,
                k_scales=ks[i] if self.kv_quantized else None,
                v_scales=vs[i] if self.kv_quantized else None)
            x = m.attn_out(i, o, x, lora=None if lora is None else
                           (lora["a_wo"], lora["b_wo"], ad_s))
            x = m.ffn(i, x, lora=None if lora is None else
                      (lora["a_ff1"], lora["b_ff1"], lora["a_ff2"],
                       lora["b_ff2"], ad_s))
        return self._greedy_topk(x, m)

    def _dispatch(self, family: str, *arrays):
        """Run one step of ``family`` (``mixed``, ``decode`` or
        ``prefill``) on the host-built int32 lane arrays: packed into
        one pinned buffer, shipped by one copy into the program's input,
        the program run (replayed on the card once captured), its
        output fetched by one copy into pinned memory. Returns numpy
        (greedy, topv, topi) — for ``prefill`` the (vocab,) f32 logits
        — and ends synchronized.

        The fault site ``serve.{family}`` fires first, before a staging
        slot is taken, a byte is copied or a graph replays: a fault the
        injector raises leaves the device and the staging ring as they
        were. So every retry of a ``TransientError`` (up to
        ``serve_max_retries``, sleeping ``serve_retry_backoff_s``,
        doubled at each retry) is safe: unlike the JAX engine, which stops
        retrying once its donated page arrays are consumed, the port
        donates nothing and nothing has reached the device yet. An error
        from the device itself (a CUDA error mid-replay) is not a
        ``TransientError`` and is never retried."""
        self._fire_with_retry(f"serve.{family}")
        self._device_pages()
        shapes = tuple(a.shape for a in arrays)
        buf = self._stage_in.take(sum(a.size for a in arrays), torch.int32)
        host, off = buf.numpy(), 0
        for a in arrays:
            host[off:off + a.size] = a.reshape(-1)
            off += a.size
        if self._lockstep is not None:
            # every rank about to feed the sharded step the same lanes
            self._lockstep.check(f"serve.{family}", host[:off])
        bound = [w for p in self._step_params.values()
                 for w in p.values()]
        bound += [t for t in (self._k_pages, self._v_pages,
                              self._k_scales, self._v_scales)
                  if t is not None]
        if self._adapter_slabs is not None:
            bound += list(self._adapter_slabs.values())
        out = self.programs.call(family, self._run_packed, family, shapes,
                                 buf, bound=bound)
        self._stage_in.consumed()
        if self.device.type == "cuda":
            got = self._stage_out.take(out.numel(), torch.int32)
            got.copy_(out.reshape(-1), non_blocking=True)
            # the copy done, the slot is free again: no event needed
            torch.cuda.current_stream(self.device).synchronize()
            res = got.numpy().reshape(tuple(out.shape)).copy()
        else:
            res = out.numpy().copy()
        if family == "prefill":
            return res.view(np.float32)
        k = self.topk_cap
        return res[:, 0], res[:, 1:1 + k].view(np.float32), res[:, 1 + k:]

    def _dispatch_mixed(self, *arrays, lane_adapters=None):
        """One mixed step: the seven lane arrays, plus the lanes'
        adapter slots on an adapter-armed engine (all 0 — the base
        slab — when None)."""
        if self.adapters is not None:
            if lane_adapters is None:
                lane_adapters = np.zeros((self.mixed_width,), np.int32)
            arrays = arrays + (lane_adapters,)
        return self._dispatch("mixed", *arrays)

    def _fire_with_retry(self, site: str) -> None:
        """Fire ``site``, retrying each TransientError with backoff (the
        JAX engine's _call_counted): a ``retry`` instant per attempt and
        a ``retry_backoff`` span over each sleep, on the engine track;
        raises once the retries are spent."""
        attempt = 0
        tel = self.telemetry
        while True:
            try:
                self.faults.fire(site)
                return
            except TransientError:
                attempt += 1
                if attempt > self.max_retries:
                    raise
                self._retries += 1
                if tel.enabled:
                    tel.instant(self._ENGINE_TRACK, "retry",
                                args={"site": site, "attempt": attempt})
                if self.retry_backoff:
                    tb = time.perf_counter()
                    time.sleep(self.retry_backoff * (2 ** (attempt - 1)))
                    if tel.enabled:
                        # dead time every request of the step pays: a
                        # span, so explain_request carves it out as retry
                        tel.span(self._ENGINE_TRACK, "retry_backoff", tb,
                                 time.perf_counter(),
                                 args={"site": site, "attempt": attempt})

    def _run_packed(self, family: str, shapes, packed):
        """The program of a family: unpack the lane arrays (views of
        ``packed``), run the family's body, pack its outputs into one
        int32 tensor: (N, 1 + 2K) [greedy | top-k values' bits | top-k
        ids], or the prefill's (vocab,) logits' bits."""
        parts, off = [], 0
        for s in shapes:
            n = math.prod(s)
            parts.append(packed[off:off + n].view(s))
            off += n
        out = getattr(self, f"_{family}_body")(*parts)
        if family == "prefill":
            return out.float().view(torch.int32)
        greedy, topv, topi = out
        return torch.cat([greedy[:, None], topv.view(torch.int32), topi],
                         dim=1)

    @torch.no_grad()
    def _decode_body(self, tokens, positions, write_pages, write_offs,
                     page_tables, seq_lens):
        """The legacy decode step: one token for every slot lane. All
        (B,) int32 on the device, host-built: tokens/positions; the
        physical (page, offset) of each lane's new K/V (lanes not
        decoding this step aim at the sink page 0 instead of clobbering
        their own position 0); page_tables (B, pages_per_seq); seq_lens
        INCLUDING the token being decoded (its K/V is written, then
        attended: position i sees keys 0..i). Non-decoding lanes compute
        garbage the host never reads. Returns (greedy, topv, topi) as
        :meth:`_greedy_topk`."""
        m = self.step_lm
        kp, vp = self._device_pages()
        x = m.embed(tokens, positions)                      # (B, E)
        scale = 1.0 / math.sqrt(self.head_dim)
        where = (write_pages.long(), write_offs.long())
        for i in range(self.num_layers):
            q, k, v = m.attn_qkv(i, m.attn_in(i, x))       # (B, H, D)
            self._write_kv(i, where, k, v)
            o = paged_attention_decode(q, kp[i], vp[i], page_tables,
                                       seq_lens, scale=scale)
            x = m.attn_out(i, o, x)
            x = m.ffn(i, x)
        return self._greedy_topk(x, m)

    def warmup(self) -> dict:
        """Allocate the page pool and ready the active path's programs
        once on throwaway inputs (every write aims at the sink page):
        the mixed step, or on the legacy path the prefill of every
        bucket and the decode step, then every signature the program
        store restored that those did not run. On the card this builds
        the kernels and captures each program; with program_cache_dir
        armed it first readies the whole kernel library in the cache.
        Returns compile_counts(); the boot record lands in
        ``boot_stats`` (``warm``: no compiler ran, and every restored
        signature was readied). A boot that captured signatures the
        store lacks writes the store back (rank 0 of a tensor group:
        every rank's signatures are the same)."""
        t0 = time.perf_counter()
        c = self.cache_cfg
        if self.programs.cache_dir and self.device.type == "cuda":
            from ..kernels import _build
            _build.build()
        self._device_pages()
        tables = np.zeros((c.max_seqs, c.pages_per_seq), np.int32)
        if self.chunked_prefill:
            t = self.mixed_width
            z = np.zeros((t,), np.int32)
            self._dispatch_mixed(z, z, z, z, tables, z,
                                 np.ones((t,), np.int32))
            if self.adapters is not None:
                # the slot load on all-zero rows aimed at the base slot
                # (zeros into zeros: a no-op on content), host f32 like
                # every real load
                self._adapter_load(0, {
                    k: np.zeros(sh, np.float32)
                    for k, sh in self._adapter_row_shapes().items()})
            if self.host_tier is not None:
                # spills and reloads run the export and import
                self.warmup_handoff()
        else:
            pt_row = np.zeros((c.pages_per_seq,), np.int32)
            one = np.ones((1,), np.int32)
            for b in self.buckets:
                self._dispatch("prefill", np.zeros((b,), np.int32), one,
                               pt_row)
            z = np.zeros((c.max_seqs,), np.int32)
            self._dispatch("decode", z, z, z, z, tables,
                           np.ones((c.max_seqs,), np.int32))
        self._ready_restored()
        rec = self.programs.boot_record()
        rec["boot_s"] = time.perf_counter() - t0
        self.boot_stats = rec
        if self.programs.dirty and (self.bm is None or self.bm.rank == 0):
            self.programs.save()
        return self.compile_counts()

    def _ready_restored(self) -> None:
        """Ready the restored signatures warmup's own steps left: the
        page export and import (an engine of this fingerprint with a
        host tier ran them) as warmup_handoff runs them. The fingerprint
        fixes every step's geometry, so a step signature still pending
        is another build's: it warns and stays pending (the boot is not
        warm)."""
        families = {f for f, _ in self.programs.pending_restored()}
        if families & {"export", "import"} and self.chunked_prefill:
            self.warmup_handoff()
        left = self.programs.pending_restored()
        if left:
            warnings.warn(f"program cache: {len(left)} restored "
                          f"signatures this engine does not run "
                          f"({sorted({f for f, _ in left})}); booting "
                          f"cold", stacklevel=3)

    # ---------------- sampling -----------------------------------------
    @staticmethod
    def _sample_params(temperature, top_k, seed, n, cap):
        """Normalize scalar-or-per-request sampling args into one
        Optional[SampleParams] per request."""
        def seq(x):
            if x is None or np.isscalar(x):
                return [x] * n
            if len(x) != n:
                raise ValueError(
                    f"per-request sampling arg has {len(x)} entries "
                    f"for {n} prompts")
            return list(x)
        out = []
        for t, k in zip(seq(temperature), seq(top_k)):
            if t is None or float(t) <= 0.0:
                if t is not None and float(t) < 0.0:
                    raise ValueError(f"temperature must be >= 0, got {t}")
                out.append(None)
                continue
            if k is not None and not (1 <= int(k) <= cap):
                raise ValueError(
                    f"top_k must be in [1, {cap}] (the engine's static "
                    f"top-k head), got {k}")
            out.append(SampleParams(temperature=float(t),
                                    top_k=None if k is None else int(k),
                                    seed=int(seed)))
        return out

    def _pick_token(self, req: Request, greedy: int, topv, topi) -> int:
        """The emitted token for a lane: greedy argmax, or a seeded
        draw from the lane's top-k logits. The RNG is stateless per
        (seed, stream-id, stream-offset + token-index) — stream_id
        defaults to the local rid, so a plain engine keeps the
        historical (seed, rid, index) keying bit-for-bit — which makes
        a fixed seed reproduce a stream exactly, preemption/resume
        replay nothing, and a stream SURVIVE crossing schedulers: the
        disaggregated decode role resumes a handed-off request at
        offset 1, and a routed replica draws the same stream a
        single-replica engine would (docs/serving.md)."""
        sp = req.sample
        if sp is None:
            return int(greedy)
        k = sp.top_k if sp.top_k is not None else self.topk_cap
        v = np.asarray(topv[:k], np.float64) / sp.temperature
        v -= v.max()
        p = np.exp(v)
        p /= p.sum()
        sid = req.rid if req.stream_id is None else req.stream_id
        rng = np.random.default_rng(
            [sp.seed, sid, req.stream_offset + len(req.out_tokens)])
        return int(topi[int(rng.choice(k, p=p))])

    # ---------------- full-sequence forward (prefill + reference) ------
    @torch.no_grad()
    def _prefill_body(self, tokens, length, pt_row):
        """The legacy prefill of one request: (S,) tokens padded to its
        bucket, its (1,) length and its (pages_per_seq,) page-table row
        -> the (vocab,) logits at position length-1, the prompt's K/V
        scattered into its pages."""
        return self._forward_tokens(tokens[None, :], length, kv=pt_row)

    @torch.no_grad()
    def _forward_tokens(self, tokens, length, kv=None, lm=None):
        """Logits (vocab,) at position length-1 of the causal forward
        over (1, S) tokens (positions >= length are padding and never
        seen by position length-1); ``length`` an int or a (1,) int
        tensor on the tokens' device; ``lm`` the block math (the
        step's at t = 1 when None). ``kv = pt_row`` (the sequence's
        (pages_per_seq,) page-table row) also scatters each layer's K/V
        of every position into the sequence's pages on the way through
        (the legacy prefill; padded positions land past the mapped range
        on table entries 0, the sink, or on offsets decode overwrites
        before the length mask exposes them). kv=None is the pure
        no-cache forward, the naive reference: ONE implementation, so
        the parity oracle and the legacy path cannot drift apart."""
        on_kv = None
        if kv is not None:
            self._device_pages()
            ps = self.cache_cfg.page_size
            pos = torch.arange(tokens.shape[1], device=tokens.device)
            where = (kv.long()[pos // ps], pos % ps)

            def on_kv(i, k, v):
                self._write_kv(i, where, k[0], v[0])
        lm = self.step_lm if lm is None else lm
        x = lm.hidden_states(tokens, on_kv=on_kv)
        last = torch.as_tensor(length, device=x.device).long().reshape(1)
        # a gather, not x[0, length - 1]: the row stays a device value
        return lm.head(x[0].index_select(0, last - 1))[0]

    def _context_logits(self, ctx: Sequence[int], lm) -> np.ndarray:
        toks = torch.tensor([list(ctx)], dtype=torch.int64,
                            device=self.device)
        return self._forward_tokens(toks, len(ctx),
                                    lm=lm).float().cpu().numpy()

    @staticmethod
    def first_divergence(a, b) -> Optional[int]:
        """Index of the first position where token streams a and b
        differ, or None when one is a prefix of the other."""
        return next((i for i, (x, y) in enumerate(zip(a, b))
                     if x != y), None)

    def assert_token_parity(self, prompts, out, ref, *,
                            margin=None) -> int:
        """The reference-parity gate for generate() outputs. Lossless
        pools (kv_exact) gate full token identity unless a ``margin``
        is given. Otherwise each request either matches the greedy
        reference token-for-token, or first diverges at a TIE: a
        position where the reference's own top-logit margin over the
        engine's pick is at most ``margin`` (default: the pool format's
        kv_tie_margin). On the card the attention kernel's online
        softmax rounds differently from the reference's single pass, so
        f32 runs there pass an explicit small margin. After one tie
        flips, the continuation legitimately diverges, so only the
        first divergence is compared. Returns the fully-identical
        request count."""
        if margin is None and self.kv_exact:
            for i, (o, r) in enumerate(zip(out, ref)):
                assert list(o) == list(r), (
                    f"request {i} diverged from reference")
            return len(out)
        if margin is None:
            margin = self.kv_tie_margin
        exact = 0
        diverged = []
        for pr, o, r in zip(prompts, out, ref):
            j = self.first_divergence(o, r)
            if j is None:
                exact += 1
            else:
                diverged.append((pr, o, r, j))
        if not diverged:
            return exact
        with self._reference_lm() as lm:
            for pr, o, r, j in diverged:
                logits = self._context_logits(list(pr) + list(r[:j]), lm)
                gap = float(logits[r[j]] - logits[o[j]])
                assert 0.0 <= gap <= margin, (
                    f"flipped a non-tie token — reference margin "
                    f"{gap:.6g} > {margin} at position {j}")
        return exact

    def generate_reference(self, prompts: Sequence[Sequence[int]],
                           max_new_tokens,
                           eos_token: Optional[int] = None
                           ) -> List[List[int]]:
        """Naive no-cache greedy decode: re-forward the WHOLE sequence
        for every new token, one request at a time. O(n^2) per token —
        the correctness oracle generate() is tested against. It runs on
        the device over the whole parameters (``_reference_lm``: a copy
        for the call only where the card holds none)."""
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompts)
        if len(max_new_tokens) != len(prompts):
            raise ValueError(
                f"max_new_tokens has {len(max_new_tokens)} entries for "
                f"{len(prompts)} prompts")
        for mnt in max_new_tokens:
            if mnt < 1:  # mirror scheduler.submit's contract
                raise ValueError(f"max_new_tokens must be >= 1, got {mnt}")
        out: List[List[int]] = []
        with self._reference_lm() as lm:
            for prompt, mnt in zip(prompts, max_new_tokens):
                toks = list(prompt)
                new: List[int] = []
                while len(new) < mnt:
                    tok = int(np.argmax(self._context_logits(toks, lm)))
                    new.append(tok)
                    toks.append(tok)
                    if eos_token is not None and tok == eos_token:
                        break
                out.append(new)
        return out

    # ---------------- the serving loop ---------------------------------
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens, eos_token: Optional[int] = None,
                 temperature=None, top_k=None, sample_seed: int = 0,
                 deadline_s=None, on_step=None, on_finish=None,
                 stream_ids: Optional[Sequence[int]] = None,
                 stream_offset: int = 0,
                 trace_ids: Optional[Sequence[int]] = None,
                 tenant_ids: Optional[Sequence[int]] = None
                 ) -> List[List[int]]:
        """Decode a ragged batch under continuous batching.
        `max_new_tokens` is an int or a per-prompt sequence; greedy by
        default, per-request seeded temperature/top-k sampling when
        `temperature` is given (scalar or per-prompt; 0 = greedy).
        Returns the generated tokens (prompt excluded) per prompt, in
        order; per-run counters land in `self.last_stats`.

        `deadline_s` (scalar or per-prompt; FFConfig.
        serve_request_deadline when None; 0/None = none) bounds each
        request's wall time from submission: expiry aborts it at the
        next step boundary with outcome "deadline_expired", and its
        partial tokens are returned. `cancel(rid)` (rids are
        `last_stats["requests"][i]["rid"]`, in prompt order) aborts a
        request the same way. `on_step(step_index)` is called after
        every engine step (where cancels and invariant checks run);
        `on_finish(req)` when a request completes, before its slot
        releases. `stream_ids`/`stream_offset` key the sampled streams
        (_pick_token), `trace_ids` carry an upstream trace context.
        `tenant_ids` pick each request's registered LoRA adapter (0 =
        the base model; others need ``adapter_rank > 0``). A
        mid-batch exception fails only the in-flight requests and the
        engine keeps serving; with telemetry on, the Chrome trace is
        written to `trace_out` after every call, one a fault aborted
        included."""
        n = len(prompts)
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * n
        samples = self._sample_params(temperature, top_k, sample_seed, n,
                                      self.topk_cap)
        if deadline_s is None and self.default_deadline > 0:
            deadline_s = self.default_deadline
        if deadline_s is not None and np.isscalar(deadline_s):
            deadline_s = [deadline_s] * n
        for name, arg in (("max_new_tokens", max_new_tokens),
                          ("deadline_s", deadline_s),
                          ("stream_ids", stream_ids),
                          ("trace_ids", trace_ids),
                          ("tenant_ids", tenant_ids)):
            if arg is not None and len(arg) != n:
                raise ValueError(f"{name} has {len(arg)} entries for "
                                 f"{n} prompts")
        if tenant_ids is not None and any(tenant_ids) \
                and self.adapters is None:
            raise ValueError(
                "tenant_ids != 0 need an armed adapter pool "
                "(adapter_rank > 0); this engine serves base-only")
        per = [dict(eos_token=eos_token, sample=sp,
                    tenant_id=(int(tenant_ids[i]) if tenant_ids is not None
                               else 0),
                    deadline_s=(deadline_s[i] if deadline_s is not None
                                else None),
                    stream_id=(stream_ids[i] if stream_ids is not None
                               else None),
                    stream_offset=stream_offset,
                    trace_id=(trace_ids[i] if trace_ids is not None
                              else None))
               for i, sp in enumerate(samples)]
        if self.chunked_prefill:
            return self._generate_session(prompts, max_new_tokens, per,
                                          on_step, on_finish)
        return self._generate_legacy(prompts, max_new_tokens, per,
                                     on_step, on_finish)

    def start_session(self) -> "ServeSession":
        """Open an incremental serving session: submit requests at any
        time, advance ONE mixed step per :meth:`ServeSession.step`,
        ``close()`` when done. Chunked engines only; at most one live
        session per engine."""
        return ServeSession(self)

    def _finish_run(self) -> None:
        """The tail every generate() runs, a failed one included: clear
        the cancel marks and the active set, export the fault accounting
        and write the Chrome trace (an unwritable ``trace_out`` warns
        and serving goes on)."""
        self._active.clear()
        self._cancels.clear()
        tel = self.telemetry
        if tel.enabled:
            tel.record_faults(self.faults)
            if self.trace_out:
                try:
                    tel.export_chrome_trace(self.trace_out)
                except OSError as e:
                    warnings.warn(f"trace_out {self.trace_out!r} is not "
                                  f"writable ({e}); no trace written")

    def _publish(self, stats: dict) -> None:
        """Check the pool drained, publish ``last_stats`` and fold it
        into the engine-lifetime registry."""
        self.cache.check_invariants()
        assert self.cache.free_pages == self.cache_cfg.usable_pages, \
            "pages leaked"
        self.last_stats = stats
        if self.telemetry.enabled:
            serve_metrics(stats, registry=self.telemetry.metrics)

    def _generate_session(self, prompts, max_new_tokens, per, on_step,
                          on_finish) -> List[List[int]]:
        """generate()'s chunked path: one ServeSession, every prompt
        submitted up front, stepped to drain."""
        session = self.start_session()
        reqs = session.reqs
        try:
            for prompt, mnt, kw in zip(prompts, max_new_tokens, per):
                session.submit(prompt, mnt, on_finish=on_finish, **kw)
            while True:
                ev = session.step()
                if ev is None:
                    break
                if ev.dispatched and on_step is not None:
                    on_step(ev.step_index)
        except Exception:
            self._fail_inflight(session.sched, reqs)
            raise
        finally:
            session.close()
            self._finish_run()
        self._publish(session.stats_dict())
        return [list(r.out_tokens) for r in reqs]

    # ---------------- the legacy bucket path ----------------------------
    def _generate_legacy(self, prompts, max_new_tokens, per, on_step,
                         on_finish) -> List[List[int]]:
        """generate()'s legacy path (serve_chunked_prefill=False): its
        own scheduler and orphan recovery (the chunked path's
        ServeSession owns both), then :meth:`_run_legacy`."""
        c = self.cache_cfg
        cache = self.cache
        if cache.free_slots != c.max_seqs:
            # a previous batch died without _fail_inflight running:
            # reclaim slots/pages, reset the pool state, serve on
            cache.release_all()
            self._reset_pool_state()
        sched = ContinuousBatchingScheduler(
            cache, prefill_token_budget=self.prefill_budget,
            chunked_prefill=False, admit_watermark=self.admit_watermark,
            spec_tokens=self.spec_tokens, faults=self.faults,
            degrade_ladder=self.degrade_ladder,
            reject_stalls=self.reject_stalls)
        reqs: List[Request] = []
        t0 = time.perf_counter()
        for prompt, mnt, kw in zip(prompts, max_new_tokens, per):
            deadline = kw.pop("deadline_s")
            r = sched.submit(prompt, mnt, **kw)
            r.t_submit = time.perf_counter()
            if deadline and float(deadline) > 0:
                r.t_deadline = r.t_submit + float(deadline)
            reqs.append(r)
            self._active[r.rid] = r
        decode_times: List[float] = []   # seconds per step with decodes
        decode_widths: List[int] = []    # decode lanes per such step
        prefill_times: List[Tuple[int, float]] = []  # (bucket, seconds)
        util: List[float] = []           # resident-page fraction per step
        retries0 = self._retries
        try:
            self._run_legacy(sched, decode_times, decode_widths,
                             prefill_times, util, on_step, on_finish)
        except Exception:
            self._fail_inflight(sched, reqs)
            raise
        finally:
            self._finish_run()
        self._publish(self._build_stats(
            reqs, sched, wall=time.perf_counter() - t0, steps=len(util),
            retries0=retries0, decode_times=decode_times,
            decode_widths=decode_widths, prefill_times=prefill_times,
            util=util))
        self._last_reqs = {r.rid: r for r in reqs}
        return [list(r.out_tokens) for r in reqs]

    def _run_legacy(self, sched, decode_times, decode_widths,
                    prefill_times, util, on_step=None,
                    on_finish=None) -> None:
        """The two-step loop: the abort sweep, per-request bucketed
        prefill (each emitting its first token through the host's
        argsort top-k), then one full-width decode of every running
        sequence."""
        c = self.cache_cfg
        cache = self.cache
        ps = c.page_size
        tel = self.telemetry

        def emit(chunk: ChunkPlan, greedy, topv, topi) -> None:
            req = chunk.req
            tok = self._pick_token(req, greedy, topv, topi)
            req.out_tokens.append(tok)
            if len(req.out_tokens) == 1:
                req.t_first_token = time.perf_counter()
            if req.is_done():
                req.t_finish = time.perf_counter()
                if on_finish is not None:
                    on_finish(req)
                sched.finish(req)

        while sched.has_work():
            self._sweep_aborts(sched)
            if not sched.has_work():
                break
            plan = sched.schedule()
            if not plan.chunks:
                continue
            t_step0 = time.perf_counter()
            pre = [ch for ch in plan.chunks if not ch.is_decode]
            dec = [ch for ch in plan.chunks if ch.is_decode]
            for ch in pre:
                req = ch.req
                ctx = req.context
                b = self.bucket_for(len(ctx))
                toks = np.zeros((1, b), np.int32)
                toks[0, :len(ctx)] = ctx
                tp = time.perf_counter()
                logits = self._dispatch(
                    "prefill", toks[0], np.array([len(ctx)], np.int32),
                    cache.page_tables[req.slot])
                prefill_times.append((b, time.perf_counter() - tp))
                sched.complete_chunk(ch)
                order = np.argsort(logits)[::-1][:self.topk_cap]
                # np.argmax, not order[0]: argsort's descending tie
                # order differs from argmax's first-wins (the parity
                # contract with generate_reference is argmax's)
                emit(ch, int(np.argmax(logits)), logits[order], order)
            if dec:
                tokens = np.zeros((c.max_seqs,), np.int32)
                positions = np.zeros((c.max_seqs,), np.int32)
                write_pages = np.zeros((c.max_seqs,), np.int32)  # sink
                write_offs = np.zeros((c.max_seqs,), np.int32)
                # the decode step must see the new token (position i
                # attends keys 0..i), so lengths include it up front;
                # rows not decoding clamp to 1 (a zero length NaNs the
                # softmax)
                seq_lens = np.maximum(np.asarray(cache.seq_lens), 1) \
                    .astype(np.int32)
                for ch in dec:
                    s, pos = ch.req.slot, ch.start
                    tokens[s] = ch.req.context[pos]
                    positions[s] = pos
                    write_pages[s] = cache.page_tables[s, pos // ps]
                    write_offs[s] = pos % ps
                    seq_lens[s] = ch.end
                tp = time.perf_counter()
                nxt, topv, topi = self._dispatch(
                    "decode", tokens, positions, write_pages,
                    write_offs, cache.page_tables, seq_lens)
                decode_times.append(time.perf_counter() - tp)
                decode_widths.append(len(dec))
                for ch in dec:
                    sched.complete_chunk(ch)
                    emit(ch, nxt[ch.req.slot], topv[ch.req.slot],
                         topi[ch.req.slot])
            util.append(1.0 - cache.free_pages / c.usable_pages)
            if tel.enabled:
                # the whole step (prefills and the decode) is one span;
                # no drift sample: the cost model prices the mixed step
                self._record_step_telemetry(
                    tel, plan, len(util) - 1, t_step0,
                    time.perf_counter() - t_step0, sched.rung, util[-1])
            if on_step is not None:
                on_step(len(util) - 1)

    # ---------------- quantized-page verification (tests) -------------
    def check_kv_scales(self) -> None:
        """Scale bookkeeping check for quantized pools (the stress
        tests' companion to PagedKVCache.check_invariants): every
        audited (page, offset) row must carry finite, non-negative K/V
        scales, and a zero scale must vouch for an all-zero code row
        (scale 0 is only ever written for an all-zero activation row,
        so anything else means the scale and its page drifted). Audits
        the RESIDENT (slot, position) rows — which exist only mid-run,
        so call it from generate()'s ``on_step`` — plus every
        prefix-cache-parked page. No-op on lossless pools."""
        if not self.kv_quantized or self._k_pages is None:
            return
        ps = self.cache_cfg.page_size
        kq = self._k_pages.float().cpu().numpy()
        vq = self._v_pages.float().cpu().numpy()
        ks = self._k_scales.cpu().numpy()
        vs = self._v_scales.cpu().numpy()

        def audit(what: str, page: int, off: int) -> None:
            for name, s, q in (("k", ks, kq), ("v", vs, vq)):
                srow = s[:, page, off, :]      # (layers, H)
                qrow = q[:, page, off, :, :]   # (layers, H, D)
                assert np.all(np.isfinite(srow)) \
                    and np.all(srow >= 0), (
                    f"{name}-scale of {what} (page {page} off {off}) "
                    f"is not finite/non-negative")
                dead = srow == 0.0
                assert np.all(qrow[dead] == 0), (
                    f"{name}-page row of {what} (page {page} off "
                    f"{off}) has zero scale but nonzero quantized "
                    f"content")

        for slot in range(self.cache_cfg.max_seqs):
            for pos in range(int(self.cache.seq_lens[slot])):
                audit(f"slot {slot} pos {pos}",
                      int(self.cache.page_tables[slot, pos // ps]),
                      pos % ps)
        for page in self.cache.parked_pages():
            for off in range(ps):
                audit("cached page", page, off)

    # ---------------- robustness --------------------------------------
    def cancel(self, rid: int) -> bool:
        """Host-side cancellation: mark request `rid` of the generate()
        in flight for abort at the next step boundary (its pages and
        prefix pins release through the refcount machinery). Safe from
        another thread or an `on_step` callback; False when no such
        request is active (finished, or a stale rid)."""
        req = self._active.get(rid)
        if req is None or req.state == RequestState.FINISHED:
            return False
        self._cancels.add(rid)
        return True

    def _sweep_aborts(self, sched) -> None:
        """Step-boundary sweep, at the top of every step before the
        scheduler plans: apply pending cancels and expire deadlines, so
        no aborted request has a chunk in flight and its slot and pages
        are free for this step's admissions."""
        now = time.perf_counter()
        tel = self.telemetry
        live = list(sched.running.values()) + list(sched.waiting)
        cancels = {r.rid for r in live if r.rid in self._cancels}
        due = {r.rid for r in live
               if r.t_deadline and now >= r.t_deadline}
        if self._lockstep is not None:
            cancels, due = self._agree_aborts(live, cancels, due)
        expired = 0
        for req in live:
            if req.rid in cancels:
                # consume the mark, applied or moot: rids restart in a
                # new session, and a stale mark must not cancel a
                # stranger
                self._cancels.discard(req.rid)
                if sched.abort(req, RequestOutcome.CANCELLED):
                    req.t_finish = now
                    if tel.enabled:
                        tel.instant(self._ENGINE_TRACK, "cancel", t=now,
                                    args={"rid": req.rid,
                                          "trace": req.trace_id})
            elif req.rid in due:
                if sched.abort(req, RequestOutcome.DEADLINE_EXPIRED):
                    req.t_finish = now
                    expired += 1
                    if tel.enabled:
                        tel.instant(self._ENGINE_TRACK,
                                    "deadline_expired", t=now,
                                    args={"rid": req.rid,
                                          "trace": req.trace_id})
        if expired >= self.DEADLINE_STORM:
            # several requests expiring at one boundary is the latency
            # collapse an operator needs a black box for
            self._auto_postmortem("deadline_storm", sched=sched,
                                  detail={"expired_this_sweep": expired})

    def _agree_aborts(self, live, cancels, due):
        """The abort sweep's decisions at t > 1, the same on every rank
        (``Lockstep.exchange``): the union of the ranks' cancel marks,
        and the deadlines rank 0's clock found past (the one clock read
        that decides anything on the host). Raises on every rank when
        the ranks' live requests differ."""
        from ..parallel.collectives import digest
        from ..parallel.mesh import TENSOR
        state = np.array([(r.rid, len(r.prompt), len(r.out_tokens))
                          for r in live], np.int64)
        items = [("c", rid) for rid in sorted(cancels)]
        if self.bm.coord(TENSOR) == 0:
            items += [("e", rid) for rid in sorted(due)]
        every = self._lockstep.exchange(
            "serve.sweep", digest(state, str(len(live))), items)
        cancels = {rid for got in every for kind, rid in got
                   if kind == "c"}
        due = {rid for kind, rid in every[0] if kind == "e"}
        return cancels, due

    def _fail_inflight(self, sched, reqs: Sequence[Request]) -> None:
        """Crash containment: a mid-batch exception fails ONLY the
        in-flight requests (every live slot releases through the
        refcount machinery), a post-mortem bundle is written when
        ``postmortem_dir`` is armed, and the pool state is reset. The
        exception still propagates; the next generate() serves
        normally."""
        now = time.perf_counter()
        failed = 0
        for req in reqs:
            if req.state != RequestState.FINISHED:
                if sched.abort(req, RequestOutcome.FAILED):
                    req.t_finish = now
                    failed += 1
        # the bundle records the scheduler and pool as the failure left
        # them, before the reset
        self._auto_postmortem("fault_abort", sched=sched,
                              detail={"failed_inflight": failed})
        self._reset_pool_state()

    def _reset_pool_state(self) -> None:
        """The tail of both recovery paths (_fail_inflight and the
        orphaned-slot self-heal): drop the prefix registry wholesale. The
        port writes its pages in place and donates nothing, so the pool
        tensors stay; but a step that died may have written part of a
        page the registry vouches for, so the registry goes, as in the
        JAX engine, and the next batch's tokens equal JAX's. Queued host
        spills go with the registry, and so does a priced reload no step
        claimed."""
        self.cache.clear_prefix()
        self._host_reload_s = 0.0
        self.cache.check_invariants()

    # ---------------- telemetry ----------------------------------------
    def _drift_predicted(self, ctx_bucket: int) -> Optional[tuple]:
        """(predicted seconds, per-task-class breakdown) of one mixed
        step at this pow2 context bucket, from the cost stack the
        placement search prices (cost_model.serve_step_tasks ->
        simulator.simulate_serve_step, and the breakdown drift_report
        folds per task class). The fixed-shape step dispatches every
        lane, so the price varies only with the context: one dict hit
        per step after a bucket's first. Priced on the machine model
        ``machine_model_file`` describes when set, else the card's
        (search/machine_model.default_machine_model). None when the
        cost stack cannot price the step."""
        if ctx_bucket not in self._drift_cache:
            try:
                from ..search import machine_model
                from ..search.simulator import (serve_step_breakdown,
                                                simulate_serve_step)
                arch = self.serve_arch(context=max(1, ctx_bucket))
                mm = None
                mf = self.config.machine_model_file
                if mf:
                    if self._drift_mm is None:
                        self._drift_mm = \
                            machine_model.default_machine_model(
                                machine_file=mf)
                    mm = self._drift_mm
                self._drift_cache[ctx_bucket] = (
                    float(simulate_serve_step(arch, self.tp, mm,
                                              lanes=self.mixed_width)),
                    serve_step_breakdown(arch, self.tp, mm,
                                         lanes=self.mixed_width))
            except Exception:
                self._drift_cache[ctx_bucket] = None
        return self._drift_cache[ctx_bucket]

    def _drift_regime(self, n_decode: int, pre_bucket: int,
                      ctx_bucket: int) -> str:
        return (f"t={self.tp} kv={self.kv_dtype} dec={n_decode} "
                f"pre={pre_bucket} ctx={ctx_bucket}")

    def set_track_process(self, proc: str) -> None:
        """Re-home this engine's telemetry tracks under a new process
        name (a replica pool labels each replica's tracks)."""
        self._proc = str(proc)
        self._ENGINE_TRACK = (self._proc, "engine")
        self._QUEUE_TRACK = (self._proc, "queue")
        self._slot_tracks: List[tuple] = []

    def _slot_track(self, slot: int):
        tracks = self._slot_tracks
        while len(tracks) <= slot:
            tracks.append((self._proc, f"slot {len(tracks)}"))
        return tracks[slot]

    # args layouts of the packed step records (Telemetry.emit_packed)
    _CHUNK_ARGS = ("rid", "trace", "start", "end", "drafted")
    _STEP_ARGS = ("step", "decode_lanes", "prefill_lanes", "drafted",
                  "rung")
    _WAIT_ARGS = ("rid", "trace", "prompt_tokens")
    _PREEMPT_ARGS = ("rid", "trace", "preemptions")
    _SPEC_ARGS = ("rid", "trace", "drafted", "accepted", "emitted")

    def _record_step_telemetry(self, tel, plan, step_idx: int,
                               t_start: float, dt: float,
                               rung: int, occupancy: float) -> None:
        """One engine step's telemetry, the JAX engine's records: the
        step span on the engine track, a chunk span per request on its
        slot track, queue-wait and requeue-wait async spans for this
        step's admissions, preemption instants, the pool-occupancy and
        rung counters, and the drift sample where the step can be
        priced (at the mean decode context before emission, as in JAX,
        summed in the chunk loop). Called AFTER the dispatch
        returned (a step a fault killed is never half-recorded),
        outside any captured region and reading no device value. Each
        event is one flat packed tuple (absolute stamp, args as a key
        tuple and values) handed to the bus in ONE
        :meth:`Telemetry.emit_packed`: the args dicts and the trace
        clock's stamps are built when the ring is read or exported."""
        P = PACKED
        dur = dt if dt > 0.0 else 0.0
        now = time.perf_counter()
        qt, et = self._QUEUE_TRACK, self._ENGINE_TRACK
        recs = []
        for req in plan.admitted:
            if req._t_requeue is not None:
                # re-admission after preemption: preempt -> readmit, with
                # the preemption ordinal in the ident so each b/e pairs
                ident = f"{req.rid}.{req.preemptions}"
                recs.append((P, "b", qt, "requeue_wait", req._t_requeue,
                             0.0, ident, self._PREEMPT_ARGS, req.rid,
                             req.trace_id, req.preemptions))
                recs.append((P, "e", qt, "requeue_wait", now, 0.0, ident,
                             None))
                req._t_requeue = None
            elif not req.t_admit:
                req.t_admit = now
                recs.append((P, "b", qt, "queue_wait", req.t_submit, 0.0,
                             req.rid, self._WAIT_ARGS, req.rid,
                             req.trace_id, len(req.prompt)))
                recs.append((P, "e", qt, "queue_wait", now, 0.0, req.rid,
                             None))
        for victim in plan.preempted:
            victim._t_requeue = now
            recs.append((P, "i", et, "preempt", now, 0.0, None,
                         self._PREEMPT_ARGS, victim.rid, victim.trace_id,
                         victim.preemptions))
        tracks = self._slot_tracks
        ck = self._CHUNK_ARGS
        drafted = n_dec = n_pre = ctx_dec = ctx_end = 0
        for ch in plan.chunks:
            req = ch.req
            nd = len(ch.draft_tokens)
            if nd:
                name = "spec_decode"
            elif ch.is_decode:
                name = "decode"
            else:
                name = "prefill"
            if ch.is_decode:
                n_dec += 1
                ctx_dec += len(req.prompt) + len(req.out_tokens)
            else:
                n_pre += ch.end - ch.start
            ctx_end += ch.end
            drafted += nd
            slot = req.slot
            track = tracks[slot] if slot < len(tracks) \
                else self._slot_track(slot)
            recs.append((P, "X", track, name, t_start, dur, None, ck,
                         req.rid, req.trace_id, ch.start, ch.end, nd))
        t_end = t_start + dt
        recs.append((P, "X", et, "step", t_start, dur, None,
                     self._STEP_ARGS, step_idx, n_dec, n_pre, drafted,
                     rung))
        recs.append((P, "C", et, "pool_occupancy", t_end, occupancy, None,
                     None))
        recs.append((P, "C", et, "rung", t_end, float(rung), None, None))
        tel.emit_packed(recs)
        if plan.chunks and self.chunked_prefill:
            ctx_b = pow2_bucket(int(ctx_dec / n_dec) if n_dec else
                                int(ctx_end / len(plan.chunks)))
            pred = self._drift_predicted(ctx_b)
            if pred is not None:
                tel.record_drift(
                    "serve", self._drift_regime(
                        n_dec, pow2_bucket(n_pre), ctx_b),
                    pred[0], dt, breakdown=pred[1])

    # ---------------- per-request latency attribution ------------------
    def explain_request(self, rid: int) -> dict:
        """Additive latency attribution of request `rid` of the last
        generate()/session run: its spans folded into ``{queue, routing,
        prefill, transfer, decode, preempt_stall, retry, host_reload,
        other}`` seconds that sum to its measured wall latency exactly
        (utils/telemetry.attribute_request). Needs telemetry and a
        terminated request; adds ``rid``/``outcome``/``tokens``."""
        if not self.telemetry.enabled:
            raise RuntimeError(
                "explain_request needs telemetry (pass telemetry= or "
                "set FFConfig.telemetry / trace_out)")
        req = self._last_reqs.get(rid)
        if req is None:
            raise KeyError(
                f"rid {rid} is not in the last run "
                f"({sorted(self._last_reqs)})")
        if not req.t_finish:
            raise ValueError(
                f"request {rid} has no finish stamp (outcome "
                f"{req.outcome!r}) — only terminated requests are "
                f"attributable")
        out = self.telemetry.explain_request(
            req.trace_id, req.t_submit, req.t_finish)
        out.update(rid=req.rid, outcome=req.outcome,
                   tokens=len(req.out_tokens),
                   # the admission-time spill-vs-recompute decision
                   # (None when the host tier never matched it)
                   host_reload=req.host_reload)
        return out

    def fold_attribution(self, registry=None) -> dict:
        """Fold every terminated request of the last run through
        :meth:`explain_request` into `registry` (default: the engine's
        lifetime registry) and return the per-component second totals.
        On demand, never on the serving path."""
        m = registry if registry is not None else self.telemetry.metrics
        totals = {c: 0.0 for c in REQUEST_COMPONENTS}
        if not self.telemetry.enabled:
            # no spans, and the disabled bus's registry is shared
            return totals
        for _, req in sorted(self._last_reqs.items()):
            if not req.t_finish:
                continue
            b = self.telemetry.explain_request(
                req.trace_id, req.t_submit, req.t_finish)
            fold_attribution(b, m)
            for c, v in b["components"].items():
                totals[c] += v
        return totals

    # ---------------- failure flight recorder ---------------------------
    def memory_ledger(self) -> dict:
        """Device byte accounting of this engine in the JAX engine's
        schema — params, KV pages and scale rows, the mixed step's
        activation estimate, the adapter pool — beside the simulator's
        memory-penalty input (cost_model.serve_device_bytes), per
        device: at t > 1 one rank's shards and pools, and
        ``reference_params_bytes``, the model's own parameters the card
        holds beside the step's (``_card_model_params``: the model's
        tensors when it lives on the card and the step reads copies of
        them, its shards at t > 1, which leaves the reference paths
        reading the model's; 0 for a model on the host, whose reference
        paths copy the whole parameters for the call only, and 0 at
        t = 1 on a model's live tensors, which the step reads).
        ``live_bytes`` reads the engine's real tensors (the step's
        parameters, the model's beside them and the allocated pools and
        slabs); ``ledger_vs_live`` holds the accounting against them.
        Components land as ``serve_hbm_bytes{component=...}`` gauges
        when telemetry is on."""
        from ..search import machine_model
        from ..search.cost_model import serve_device_bytes
        from ..search.explain import pytree_device_bytes
        c = self.cache_cfg
        t = max(1, self.tp)
        params = pytree_device_bytes(self._step_params)
        beside = self._card_model_params()
        whole = pytree_device_bytes(beside)
        kv_pool = float(c.pool_device_bytes)   # values + scale rows
        act_itemsize = float(self.act_dtype.itemsize)
        # the live set of ONE mixed step: lane activations through the
        # widest tensors (qkv, ffn hidden, logits) — an estimate
        activations = float(self.mixed_width) * act_itemsize * (
            self.hidden + 3.0 * self.num_heads * self.head_dim / t
            + float(self._ff_pad) / t + float(self._vocab_pad) / t)
        adapter = (float(self.adapter_cfg.pool_device_bytes)
                   if self.adapter_cfg is not None else 0.0)
        total = params + whole + kv_pool + activations + adapter
        pools_live = self._k_pages is not None
        adapters_live = self._adapter_slabs is not None
        live = params + pytree_device_bytes(
            (beside, self._k_pages, self._v_pages,
             self._k_scales, self._v_scales, self._adapter_slabs))
        arch = self.serve_arch()
        # what the placement search prices (resident_bytes at t > 1)
        sim_input = float(serve_device_bytes(arch, t)) \
            + (whole if t > 1 else 0.0)
        ledger = {
            "tensor_parallel": t,
            "params_bytes": params,
            "reference_params_bytes": whole,
            "kv_pool_bytes": kv_pool,
            "activation_est_bytes": activations,
            "adapter_bytes": adapter,
            "total_bytes": total,
            "live_bytes": live,
            "pools_live": pools_live,
            "adapters_live": adapters_live,
            "ledger_vs_live": (
                (params + whole + kv_pool
                 + (adapter if adapters_live else 0.0)) / live
                if pools_live and live > 0 else None),
            "sim_hbm_input_bytes": sim_input,
        }
        try:
            mm = machine_model.default_machine_model(
                machine_file=self.config.machine_model_file)
            ledger["hbm_capacity_bytes"] = float(mm.spec.hbm_capacity)
            ledger["hbm_utilization"] = total / ledger[
                "hbm_capacity_bytes"]
        except Exception:
            pass  # no machine model: the byte accounting stands alone
        tel = self.telemetry
        if tel.enabled:
            for comp in ("params", "kv_pool", "activation_est",
                         "adapter", "total", "live",
                         "sim_hbm_input"):
                tel.metrics.set("serve_hbm_bytes",
                                ledger[f"{comp}_bytes"], component=comp)
        return ledger

    def postmortem_bundle(self, reason: str = "manual",
                          detail: Optional[dict] = None,
                          sched=None) -> dict:
        """The bounded post-mortem bundle, in the JAX engine's schema
        (``flexflow_tpu.postmortem/1``, which ``tools/postmortem.py``
        loads): the last ``postmortem_events`` ring events, metrics and
        drift snapshots, scheduler and KV-pool state, fault accounting,
        capture counts and the trimmed last_stats. Each section is
        guarded: a collector that fails loses that section only."""
        tel = self.telemetry
        if sched is None:
            sched = self._session.sched if self._session else None
        bundle = {
            "schema": "flexflow_tpu.postmortem/1",
            "reason": str(reason),
            "detail": dict(detail or {}),
            "created_unix_s": time.time(),
            "engine": {
                "mode": "chunked" if self.chunked_prefill else "legacy",
                "mixed_width": self.mixed_width,
                "tensor_parallel": self.tp,
                "kv_dtype": self.kv_dtype,
                "max_seqs": self.cache_cfg.max_seqs,
                "prefill_budget": self.prefill_budget,
                "track_process": self._proc,
                "device": str(self.device),
            },
            "compile_counts": self.compile_counts(),
            "events": tel.events_tail(self.postmortem_events),
            "events_dropped": tel.dropped_events,
        }
        for key, collect in (
                ("metrics", tel.metrics.snapshot),
                ("drift", tel.drift_snapshot),
                ("memory_ledger", self.memory_ledger),
                ("scheduler", (sched.debug_state if sched is not None
                               else lambda: None)),
                ("kv_pool", self.cache.debug_state),
                ("adapter_pool", lambda: (
                    self.adapters.debug_state()
                    if self.adapters is not None else None)),
                ("faults", lambda: {
                    "fired": {s: dict(k) for s, k in
                              self.faults.fired.items()},
                    "site_hits": dict(self.faults._count)}),
                ("last_stats", self._trimmed_last_stats)):
            try:
                bundle[key] = collect()
            except Exception as e:   # a collector bug loses ONE section
                bundle[key] = {"error": f"{type(e).__name__}: {e}"}
        return bundle

    def _trimmed_last_stats(self) -> Optional[dict]:
        st = self.last_stats
        if not st:
            return None
        st = dict(st)
        reqs = st.get("requests")
        if isinstance(reqs, list) and len(reqs) > 64:
            st["requests"] = reqs[-64:]
            st["requests_trimmed"] = len(reqs) - 64
        # the per-step lists grow with the run; keep their tails
        for k in ("decode_step_times_s", "decode_widths",
                  "prefill_times_s"):
            v = st.get(k)
            if isinstance(v, list) and len(v) > 256:
                st[k] = v[-256:]
        return st

    def _postmortem_path(self, reason: str) -> str:
        """``postmortem-<reason>-<pid>-<n>.json`` under postmortem_dir
        (the working directory when unset), tools/postmortem.py's
        naming."""
        base = self.postmortem_dir or "."
        os.makedirs(base, exist_ok=True)
        self._postmortem_seq += 1
        return os.path.join(
            base, f"postmortem-{reason}-{os.getpid()}-"
                  f"{self._postmortem_seq}.json")

    def dump_postmortem(self, path: Optional[str] = None,
                        reason: str = "manual",
                        detail: Optional[dict] = None,
                        sched=None) -> str:
        """Write the bundle atomically (tmp + rename) and return its
        path. The explicit trigger: always writes, no rate limit."""
        bundle = self.postmortem_bundle(reason, detail, sched=sched)
        if path is None:
            path = self._postmortem_path(reason)
        return write_json_atomic(path, bundle)

    def _auto_postmortem(self, reason: str, sched=None,
                         detail: Optional[dict] = None) -> Optional[str]:
        """The auto-triggered dump (fault abort, deadline storm, rung-4
        rejection): only with ``postmortem_dir`` armed, at most one
        every POSTMORTEM_MIN_INTERVAL_S, and it never raises: a black
        box must not mask the failure it records."""
        if not self.postmortem_dir or not self.telemetry.enabled:
            return None
        now = time.monotonic()
        if now - self._postmortem_last < self.POSTMORTEM_MIN_INTERVAL_S:
            return None
        self._postmortem_last = now
        try:
            path = self.dump_postmortem(reason=reason, detail=detail,
                                        sched=sched)
            self.telemetry.instant(self._ENGINE_TRACK, "postmortem_dump",
                                   args={"reason": reason, "path": path})
            return path
        except Exception:
            return None

    def _build_stats(self, reqs, sched, *, wall, steps, retries0,
                     decode_times, decode_widths, prefill_times,
                     util) -> dict:
        """The last_stats dict (the JAX engine's keys for what this
        slice serves)."""
        cache = self.cache
        total_new = sum(len(r.out_tokens) for r in reqs)
        peak_util = float(np.max(util)) if util else 0.0
        return {
            "requests": [
                {"rid": r.rid, "trace_id": r.trace_id,
                 "tenant": int(r.tenant_id),
                 "prompt_tokens": len(r.prompt),
                 "new_tokens": len(r.out_tokens),
                 "preemptions": r.preemptions,
                 "outcome": r.outcome,
                 "ttft_s": (r.t_first_token - r.t_submit
                            if r.t_first_token else None),
                 "latency_s": (r.t_finish - r.t_submit
                               if r.t_finish else None)}
                for r in reqs],
            "mode": "chunked" if self.chunked_prefill else "legacy",
            "device": str(self.device),
            "wall_s": wall,
            "total_new_tokens": total_new,
            "tokens_per_sec": total_new / wall if wall > 0 else 0.0,
            "steps": steps,
            "decode_steps": len(decode_times),
            "decode_step_times_s": decode_times,
            "decode_widths": decode_widths,
            "prefill_times_s": prefill_times,
            "compile_counts": self.compile_counts(),
            "prompt_tokens_total": sched.stats["prompt_tokens"],
            "prefill_tokens_computed": sched.stats["prefill_lane_tokens"],
            "prefix_hit_tokens": sched.stats["prefix_hit_tokens"],
            "preemptions": sched.stats["preemptions"],
            "spec_tokens": self.spec_tokens,
            "spec_drafted_tokens": sched.stats["spec_drafted_tokens"],
            "spec_accepted_tokens": sched.stats["spec_accepted_tokens"],
            "spec_acceptance": (
                sched.stats["spec_accepted_tokens"]
                / sched.stats["spec_drafted_tokens"]
                if sched.stats["spec_drafted_tokens"] else 0.0),
            "decode_tokens": int(sum(decode_widths)),
            "steps_per_decode_token": (
                sched.stats["decode_lane_tokens"] / sum(decode_widths)
                if decode_widths else 0.0),
            "page_util_mean": float(np.mean(util)) if util else 0.0,
            "page_util_max": peak_util,
            "cancelled": sched.stats["cancelled"],
            "deadline_expired": sched.stats["deadline_expired"],
            "rejected": sched.stats["rejected"],
            "rejected_requests": [(rr.rid, rr.reason)
                                  for rr in sched.rejected_requests],
            "retries": self._retries - retries0,
            "degradation_rung_max": sched.stats["degradation_rung_max"],
            "rung_steps": list(sched.stats["rung_steps"]),
            "spec_shed_steps": sched.stats["spec_shed_steps"],
            # tensor-parallel facts (None on one device)
            "sharding": self._sharding_stats(),
            "cache": dict(cache.stats),   # engine-lifetime counters
            "kv_pool": {**cache.pool_report(), "occupancy": peak_util,
                        "kv_exact": self.kv_exact,
                        "attn_block_kv": self.attn_block_kv},
            # the host tier (None unarmed): the store's occupancy and
            # counters plus THIS engine's reload accounting
            "host_tier": (
                {**self.host_tier.report(),
                 **{k: (float(v) if isinstance(v, float) else int(v))
                    for k, v in self._host_reload_stats.items()}}
                if self.host_tier is not None else None),
            # the adapter pool (None unarmed): slot geometry, residency
            # and the hit/evict/load/stall counters
            "adapter_pool": (
                {**self.adapters.pool_report(),
                 **{k: int(v) for k, v in self.adapters.stats.items()},
                 "blocked_steps": sched.stats["adapter_blocked_steps"]}
                if self.adapters is not None else None),
        }


class StepEvents:
    """What one :meth:`ServeSession.step` did — the replica pool's view
    of a replica's progress: ``emitted`` is [(request, tokens emitted
    this step)], ``finished`` the requests that completed THIS step,
    ``ctx_mean`` the mean decode-context length (the pricing regime of
    the virtual clock), ``host_reload_s`` the priced host-tier copy
    seconds this step's admissions spent, ``dispatched`` False for a
    planning-only iteration."""

    __slots__ = ("dispatched", "step_index", "plan", "emitted",
                 "finished", "ctx_mean", "wall_s", "host_reload_s")

    def __init__(self, plan=None):
        self.dispatched = False
        self.step_index = -1
        self.plan = plan
        self.emitted: List[Tuple[Request, int]] = []
        self.finished: List[Request] = []
        self.ctx_mean = 0
        self.wall_s = 0.0
        self.host_reload_s = 0.0


class ServeSession:
    """Incremental (steppable) serving over one ServeEngine. The
    session owns the scheduler (and with it the engine's slots); at
    most one is live per engine until ``close()``. Each step: sweep
    cancels and deadlines, plan, pack lanes, dispatch the ONE mixed
    step, record its telemetry, then bookkeeping first / emission
    second / speculative verification last."""

    def __init__(self, engine: ServeEngine):
        if not engine.chunked_prefill:
            raise ValueError(
                "serving sessions need the chunked mixed program "
                "(serve_chunked_prefill=True); the legacy bucket path "
                "has no single-step form")
        if engine._session is not None:
            raise RuntimeError(
                "engine already has a live ServeSession — close() it "
                "first (the session's scheduler owns the slots)")
        self.eng = engine
        cache = engine.cache
        c = engine.cache_cfg
        if cache.free_slots != c.max_seqs:
            # a previous batch died without _fail_inflight running:
            # reclaim slots/pages, reset the pool state, serve on
            cache.release_all()
            engine._reset_pool_state()
        self.sched = ContinuousBatchingScheduler(
            cache, prefill_token_budget=engine.prefill_budget,
            chunked_prefill=True,
            admit_watermark=engine.admit_watermark,
            spec_tokens=engine.spec_tokens, faults=engine.faults,
            degrade_ladder=engine.degrade_ladder,
            reject_stalls=engine.reject_stalls,
            adapter_pool=engine.adapters,
            host_reload=(engine._host_reload
                         if engine.host_tier is not None else None))
        self.reqs: List[Request] = []
        self._on_finish: Dict[int, object] = {}
        self.decode_times: List[float] = []
        self.decode_widths: List[int] = []
        self.prefill_times: List[Tuple[int, float]] = []
        self.util: List[float] = []
        self._retries0 = engine._retries
        self._rejected_seen = 0   # the flight recorder's rejection trigger
        self._spec_recs: List[tuple] = []   # a step's spec_verify events
        self._t0 = time.perf_counter()
        engine._device_pages()
        engine._session = self

    # ---------------- submission ---------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               eos_token: Optional[int] = None,
               sample: Optional[SampleParams] = None,
               deadline_s: Optional[float] = None,
               stream_id: Optional[int] = None,
               stream_offset: int = 0, on_finish=None,
               trace_id: Optional[int] = None,
               tenant_id: int = 0) -> Request:
        """Queue one request (admission happens at the next step()).
        `sample` is a ready SampleParams (None = greedy); `deadline_s`
        (the engine's default deadline when None) bounds its wall time
        from now; `stream_id`/`stream_offset` key its sampling stream;
        `trace_id` carries an upstream trace context (None mints one);
        `on_finish(req)` fires when it completes, before its slot
        releases; `tenant_id` selects the tenant's registered LoRA
        adapter (0 = the base model)."""
        r = self.sched.submit(prompt, int(max_new_tokens),
                              eos_token=eos_token, sample=sample,
                              stream_id=stream_id,
                              stream_offset=stream_offset,
                              trace_id=trace_id, tenant_id=tenant_id)
        r.t_submit = time.perf_counter()
        if deadline_s is None and self.eng.default_deadline > 0:
            deadline_s = self.eng.default_deadline
        if deadline_s and float(deadline_s) > 0:
            r.t_deadline = r.t_submit + float(deadline_s)
        if on_finish is not None:
            self._on_finish[r.rid] = on_finish
        self.reqs.append(r)
        self.eng._active[r.rid] = r
        return r

    def has_work(self) -> bool:
        return self.sched.has_work()

    # ---------------- emission -----------------------------------------
    def _finish(self, ev: StepEvents, req: Request) -> None:
        req.t_finish = time.perf_counter()
        cb = self._on_finish.pop(req.rid, None)
        if cb is not None:
            cb(req)
        self.sched.finish(req)
        self.eng._active.pop(req.rid, None)
        ev.finished.append(req)

    def _emit(self, ev: StepEvents, chunk: ChunkPlan, greedy, topv,
              topi) -> None:
        req = chunk.req
        tok = self.eng._pick_token(req, greedy, topv, topi)
        req.out_tokens.append(tok)
        ev.emitted.append((req, 1))
        if len(req.out_tokens) == 1:
            req.t_first_token = time.perf_counter()
        if req.is_done():
            self._finish(ev, req)

    def _emit_spec(self, ev: StepEvents, chunk: ChunkPlan, lane0: int,
                   greedy, topv, topi) -> int:
        """Verify a speculative decode chunk and emit its step's
        tokens: walk lanes lane0..lane0+k (the context token and the k
        drafts), picking each lane's token exactly as sequential
        decode would — lane j's logits are valid BECAUSE every earlier
        pick matched the draft that fed lane j+1 — and stop at the
        first mismatch (that pick IS the corrected token), at EOS /
        max_new, or after the bonus token when every draft held. Then
        the scheduler commits the verified prefix and rolls the
        rejected tail's pages back. Returns the number of tokens
        emitted (1 when k=0 — the plain decode step, bit for bit)."""
        eng = self.eng
        req = chunk.req
        k = len(chunk.draft_tokens)
        matched = emitted = 0
        for j in range(k + 1):
            ln = lane0 + j
            tok = eng._pick_token(req, greedy[ln], topv[ln], topi[ln])
            req.out_tokens.append(tok)
            emitted += 1
            ok = j < k and tok == chunk.draft_tokens[j]
            if ok:
                matched += 1
            if req.is_done() or not ok:
                break
        self.sched.complete_spec_chunk(chunk, matched)
        if eng.telemetry.enabled:
            # packed, and handed to the bus with the step's other
            # verifications in one emit_packed
            self._spec_recs.append((
                PACKED, "i", eng._slot_track(req.slot), "spec_verify",
                time.perf_counter(), 0.0, None, eng._SPEC_ARGS, req.rid,
                req.trace_id, k, matched, emitted))
        ev.emitted.append((req, emitted))
        if req.is_done():
            self._finish(ev, req)
        return emitted

    # ---------------- the step -----------------------------------------
    def step(self) -> Optional[StepEvents]:
        """Advance one engine step. Returns None when the session is
        drained (no request survives the abort sweep), else a
        StepEvents."""
        eng = self.eng
        sched = self.sched
        cache = eng.cache
        c = eng.cache_cfg
        # the step boundary: cancels and expired deadlines leave HERE,
        # before any of this step's chunks exist
        eng._sweep_aborts(sched)
        if not sched.has_work():
            return None
        plan = sched.schedule()
        ev = StepEvents(plan)
        # claim the priced host-tier copy this plan's admissions spent
        # (carried even on planning-only iterations)
        ev.host_reload_s, eng._host_reload_s = eng._host_reload_s, 0.0
        if sched.stats["rejected"] > self._rejected_seen:
            # a rung-4 rejection: one bundle per rate-limit window
            self._rejected_seen = sched.stats["rejected"]
            eng._auto_postmortem("rejection", sched=sched)
        if not plan.chunks:
            # every waiting request was rejected (rung 4); the next
            # step() re-plans (forced progress: this cannot spin)
            return ev
        t_w = eng.mixed_width
        ps = c.page_size
        tokens = np.zeros((t_w,), np.int32)
        positions = np.zeros((t_w,), np.int32)
        write_pages = np.zeros((t_w,), np.int32)   # sink by default
        write_offs = np.zeros((t_w,), np.int32)
        lane_slots = np.zeros((t_w,), np.int32)
        lane_lens = np.ones((t_w,), np.int32)      # NaN-free padding
        # inactive lanes gather adapter slot 0 (the zero base slab)
        lane_adapters = np.zeros((t_w,), np.int32) \
            if eng.adapters is not None else None
        lane = 0
        emitters: List[Tuple[ChunkPlan, int]] = []
        spec_emitters: List[Tuple[ChunkPlan, int]] = []
        for ch in plan.chunks:
            ctx = ch.req.context
            row = cache.page_tables[ch.req.slot]
            lane0 = lane
            for pos in range(ch.start, ch.end):
                tokens[lane] = ctx[pos]
                positions[lane] = pos
                write_pages[lane] = row[pos // ps]
                write_offs[lane] = pos % ps
                lane_slots[lane] = ch.req.slot
                lane_lens[lane] = pos + 1
                lane += 1
            if ch.draft_tokens:
                spec_emitters.append((ch, lane - 1))
                for j, d in enumerate(ch.draft_tokens):
                    pos = ch.end + j
                    tokens[lane] = d
                    positions[lane] = pos
                    write_pages[lane] = row[pos // ps]
                    write_offs[lane] = pos % ps
                    lane_slots[lane] = ch.req.slot
                    lane_lens[lane] = pos + 1
                    lane += 1
            elif ch.emits:
                emitters.append((ch, lane - 1))
            if lane_adapters is not None:
                lane_adapters[lane0:lane] = ch.req.adapter_slot or 0
        assert lane <= t_w, (
            f"scheduler packed {lane} lanes into a {t_w}-lane step")
        # land the adapters this plan admitted BEFORE their lanes
        # dispatch, and ship queued evictions to the host tier before
        # the step overwrites their pages
        eng._drain_adapter_loads()
        eng._drain_spills()
        tp = time.perf_counter()
        greedy, topv, topi = eng._dispatch_mixed(
            tokens, positions, write_pages, write_offs,
            cache.page_tables, lane_slots, lane_lens,
            lane_adapters=lane_adapters)
        dt = time.perf_counter() - tp
        self.util.append(1.0 - cache.free_pages / c.usable_pages)
        if eng.telemetry.enabled:
            # the step span: host time from _dispatch's entry to the end
            # of its synchronize
            eng._record_step_telemetry(
                eng.telemetry, plan, len(self.util) - 1, tp, dt,
                sched.rung, self.util[-1])
        # bookkeeping FIRST (page commits hash the context as it was
        # when the chunk ran), emission second; speculative chunks
        # verify LAST — their residency bookkeeping is a function of
        # the tokens they emit
        for ch in plan.chunks:
            if not ch.draft_tokens:
                sched.complete_chunk(ch)
        dec_tokens = 0
        for ch, ln in emitters:
            self._emit(ev, ch, greedy[ln], topv[ln], topi[ln])
            if ch.is_decode:
                dec_tokens += 1
        for ch, ln in spec_emitters:
            dec_tokens += self._emit_spec(ev, ch, ln, greedy, topv,
                                          topi)
        if self._spec_recs:
            eng.telemetry.emit_packed(self._spec_recs)
            self._spec_recs = []
        if plan.num_decode_lanes:
            self.decode_times.append(dt)
            # width = tokens this step's decode chunks EMITTED
            # (speculation makes it exceed the decode-lane count)
            self.decode_widths.append(dec_tokens)
        if plan.num_prefill_lanes:
            self.prefill_times.append((plan.num_prefill_lanes, dt))
        ev.dispatched = True
        ev.step_index = len(self.util) - 1
        ev.wall_s = dt
        # the mean decode context after this step's emission (chunk
        # ends when nothing decodes): the virtual clock's price regime
        ctxs = [len(ch.req.prompt) + len(ch.req.out_tokens)
                for ch in plan.chunks if ch.is_decode] \
            or [ch.end for ch in plan.chunks]
        ev.ctx_mean = int(sum(ctxs) / len(ctxs))
        return ev

    # ---------------- stats / lifecycle --------------------------------
    def stats_dict(self) -> dict:
        """This session's last_stats-shaped dict so far."""
        return self.eng._build_stats(
            self.reqs, self.sched,
            wall=time.perf_counter() - self._t0,
            steps=len(self.util), retries0=self._retries0,
            decode_times=self.decode_times,
            decode_widths=self.decode_widths,
            prefill_times=self.prefill_times, util=self.util)

    def close(self) -> None:
        """Release the session (idempotent): the engine can open a new
        one. Does NOT abort live requests — drain first, or cancel."""
        if self.eng._session is self:
            self.eng._session = None
        if self.reqs:
            # the closed session's requests are explain_request's
            # namespace (rids restart per session)
            self.eng._last_reqs = {r.rid: r for r in self.reqs}
        for r in self.reqs:
            self.eng._active.pop(r.rid, None)
            self.eng._cancels.discard(r.rid)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
