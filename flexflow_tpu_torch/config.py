"""Configuration of the PyTorch/CUDA port, and its device policy.

``FFConfig`` carries the fields of ``flexflow_tpu/config.py`` that the
port's slices read, under the same names and defaults, so one set of
knobs sizes both packages: the serving fields of the serving slice and
the training fields of the training slice, and the mixed-precision
policy of ``core/precision.py``, ``remat`` and
``iter_config.seq_length``, the conv knobs ``conv_layout`` and
``sibling_conv_fusion``, the sparse embedding routing
(``sparse_embedding_updates``, ``sparse_embedding_lazy``) and
``moe_dispatch``, the robustness and observability knobs
(``fault_spec``, the serving retry and deadline knobs, telemetry,
``trace_out``, the metrics endpoint, post-mortems, the SLO budget and
``train_dispatch_depth``), the serving tier's LoRA adapter, host
tier, replica-pool, wall-clock, disaggregation and transport knobs, and
the search stack's machine file and cost cache, and the strategy
search's fields (gates, budget, chains, strategy files, measurement,
exports, gradient buckets, pipelines, fusion, the mesh description,
ZeRO-1). A mesh of several devices executes on a process group of its
size (parallel/mesh.py), pipelines included (``pipeline_stages > 1``
needs a mesh axis of the stage count, or ``FFModel.compile`` raises
JAX's ``ValueError``).

The command line is JAX's: ``FFConfig(argv=...)`` and
:meth:`FFConfig.from_args` parse the reference's flags through JAX's
three tables (``_FLAG_MAP``, ``_BOOL_FLAGS``, ``_NEG_BOOL_FLAGS``) and
``--seq-length``, each flag setting the field of the same name; flags
no table names are left alone, so a script's own flags pass through.
``python -m flexflow_tpu_torch`` (``__main__.py``) runs a script with
them. JAX's ``multi_step_unroll`` has no counterpart (the port has no
scan whose carry could double).

Device policy: every entry point runs on the card unless the caller
asks for the CPU. There is no fallback — :func:`resolve_device` raises
when CUDA is asked for and missing. :func:`torch_dtype` is the one map
from the dtypes a caller of the JAX package passes (numpy's, JAX's,
names) to the torch dtype a port ``Tensor`` holds.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .core.precision import resolve_dtype
from .utils.faults import FaultSpec

# the ONE --kv-dtype allowlist (flexflow_tpu/config.py KV_DTYPES); the
# port's engine serves all four (int8/float8_e4m3 on the mixed step only)
KV_DTYPES = ("float32", "bfloat16", "int8", "float8_e4m3")


class CompMode:
    """Computation mode of ``FFModel.compile``: INFERENCE builds the
    parameters without optimizer slots (what a serving engine compiles
    a model with) and refuses to train."""

    TRAINING = "training"
    INFERENCE = "inference"


class ParameterSyncType:
    """How the reference moved a parameter's gradients (ffconst.h:44-48),
    kept for its API with JAX's string values. The port's gradient sum
    is the executor's (``GradSync`` over torch.distributed on a mesh),
    whatever this says."""

    NONE = "none"
    PS = "ps"
    NCCL = "nccl"


def _int_or_auto(v) -> Union[int, str]:
    """--serve-replicas value parser: an explicit replica count, or
    'auto' to resolve the pool shape through the 2-D serve-mesh search
    (search/serve_place.optimize_serve_mesh)."""
    s = str(v).strip()
    return "auto" if s == "auto" else int(s)


@dataclasses.dataclass
class FFIterationConfig:
    """Per-iteration runtime config: ``seq_length`` >= 0 masks the
    attention keys (and BatchMatmul's marked dims) at and past it."""

    seq_length: int = -1

    def reset(self) -> None:
        self.seq_length = -1


@dataclasses.dataclass
class FFConfig:
    """The serving and training knobs of ``flexflow_tpu.config.FFConfig``."""

    # training (model.py fit/compile, core/executor.py init_state).
    # iterations and weight_decay are the reference's fields, kept with
    # JAX's defaults for the scripts that read them: nothing in either
    # package does (an optimizer takes its own weight_decay)
    batch_size: int = 64
    epochs: int = 1
    iterations: int = 1
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    seed: int = 0
    # master dtype of float parameters and optimizer state (the
    # mixed-precision policy, core/precision.py)
    param_dtype: torch.dtype = torch.float32
    # embedding-table updates (core/executor.py _sparse_table_ops, the
    # JAX executor's routing): a table whose ids are graph inputs trains
    # through the optimizer's sparse row rule — SGD without momentum
    # always ("exact": (-lr) * g added once per id occurrence, which is
    # not the dense update where ids repeat), SGD with momentum and Adam
    # only when sparse_embedding_lazy opts in (untouched rows keep stale
    # slots). False trains every table densely through autograd
    sparse_embedding_updates: bool = True
    sparse_embedding_lazy: bool = False
    # MoE dispatch (ops/moe.py use_sorted_dispatch): "auto" takes the
    # sorted scatter above DENSE_MASK_ELEMENT_LIMIT mask elements, else
    # the dense one-hot mask; "dense" and "sorted" force one path
    moe_dispatch: str = "auto"

    # dtype the step computes in: params and float inputs are cast to
    # it inside the differentiated region, losses and metrics score
    # f32-upcast logits (core/precision.py); build_transformer_lm also
    # wires it into the embeddings' output dtype, the served LM's
    # activation dtype
    compute_dtype: torch.dtype = torch.float32

    # block-paged KV-cache geometry (serve/kv_cache.py): page 0 is the
    # write sink for padding lanes
    kv_page_size: int = 16
    kv_num_pages: int = 257
    kv_dtype: str = "float32"
    # size the pool by byte budget instead of page count (0 = use
    # kv_num_pages)
    kv_pool_mb: float = 0.0

    # continuous-batching scheduler caps and the mixed-step geometry
    # (serve_prefill_budget + serve_max_seqs lanes)
    serve_max_seqs: int = 8
    serve_prefill_budget: int = 512
    serve_chunked_prefill: bool = True
    serve_prefix_cache: bool = True
    serve_admit_watermark: float = 0.02

    # speculative decoding (serve/speculative.py)
    serve_spec_decode: bool = True
    serve_spec_tokens: int = 4

    # the warm boot's directory (--program-cache-dir): the kernel-
    # library cache in <dir>/kernels (kernels/_build.py) and the program
    # stores <dir>/<fingerprint>.ffprog of the engines, executors and
    # replica pools (core/programs.py); None keeps the libraries in the
    # checkout's _build/ and stores nothing
    program_cache_dir: Optional[str] = None

    # tuning knob of the ragged paged-attention kernel: KV tokens per
    # work item in the JAX package, any value >= 0; the port maps it
    # onto the keys of the kernel's K/V tile (0 = the kernel's default;
    # kernels/paged_ragged_v2.py _tile_for). It changes no result
    serve_attn_block_kv: int = 0

    # the tensor-parallel serve mesh: "" one device, "N" that degree,
    # "auto" the placement search's degree (search/serve_place.py). A
    # degree above 1 shards the engine over that many ranks of the
    # running process group (serve/engine.py)
    serve_mesh: str = ""

    # the search stack (search/): machine_model_file overrides fields
    # of the card's MachineSpec from JSON (the JAX package's file
    # format); the serve searches keep their step prices in a
    # persistent cost cache (search_cost_cache; cost_cache_file None =
    # costcache.json under the kernels' build directory) and trace
    # their walks (search_trace)
    machine_model_file: Optional[str] = None
    search_cost_cache: bool = True
    cost_cache_file: Optional[str] = None
    search_trace: bool = True

    # multi-tenant LoRA adapters (serve/adapters.py): adapter_rank > 0
    # arms the device slab pool, one slot per resident tenant, gathered
    # per lane inside the one mixed step (chunked prefill only);
    # adapter_pool_mb sizes the slot count by byte budget (0 = 1 +
    # serve_max_seqs slots); tenant_adapters is the synthetic tenant
    # count traffic mixes register (tenants 1..N)
    adapter_rank: int = 0
    adapter_pool_mb: float = 0.0
    tenant_adapters: int = 4

    # host-RAM tier below the page pool (serve/host_tier.py): byte
    # budget of the store that evicted prefix pages spill to and reload
    # from when the priced copy beats recompute (0 = unarmed)
    host_tier_mb: float = 0.0
    serve_host_tier: bool = True

    # multi-replica serving (serve/router.py): replicas behind a
    # prefix-affinity ("affinity") or "round_robin" router on the
    # virtual clock; slo_ttft_ms / slo_tpot_ms define goodput under SLO
    # (0 = that bound waived); serve_autoscale arms the autoscaler, up
    # to serve_autoscale_max replicas (0 = 2x serve_replicas).
    # serve_replicas="auto" boots the (tensor, replicas) shape of the
    # 2-D mesh search. serve_wall_clock runs the pool in real time,
    # each replica on its own worker thread, or at a tensor degree
    # above 1 every replica from one thread in lockstep on rank 0's
    # clock (not with the autoscaler, which replays on the virtual
    # clock)
    serve_replicas: Union[int, str] = 1
    router_policy: str = "affinity"
    slo_ttft_ms: float = 0.0
    slo_tpot_ms: float = 0.0
    serve_autoscale: bool = False
    serve_autoscale_max: int = 0
    serve_wall_clock: bool = False

    # disaggregated prefill/decode serving (serve/disagg.py):
    # serve_disagg makes serve.engine_for build a DisaggCluster;
    # serve_disagg_ratio is "P:D" engine counts ("" = 1:1, "auto" =
    # the placement search's ratio table); serve_disagg_decode_budget
    # is the decode role's prefill-lane stub (0 = two pages' worth).
    # serve_transport "tcp" ships the page handoffs as socket frames
    # (serve/transport.py; "" = in process) to a receiver bound at
    # serve_transport_host:serve_transport_port (0 = ephemeral)
    serve_disagg: bool = False
    serve_disagg_ratio: str = ""
    serve_disagg_decode_budget: int = 0
    serve_transport: str = ""
    serve_transport_host: str = "127.0.0.1"
    serve_transport_port: int = 0

    # graceful-degradation ladder (serve/scheduler.py)
    serve_degrade_ladder: bool = True
    serve_reject_stalls: int = 0

    # robustness (utils/faults.py): a fault spec such as
    # "serve.mixed:transient@2,5;serve.page_pressure:exhaust:0.5@3-9"
    # arms seeded failures at marked sites, scoped to the engine or
    # model built from this config (None = the process default,
    # FLEXFLOW_TPU_FAULTS). serve_request_deadline is the default
    # per-request wall-clock deadline in seconds (0 = none); a
    # TransientError at a serving dispatch is retried up to
    # serve_max_retries times, sleeping serve_retry_backoff_s * 2^k
    # before retry k + 1
    fault_spec: Optional[str] = None
    serve_request_deadline: float = 0.0
    serve_max_retries: int = 3
    serve_retry_backoff_s: float = 0.02

    # the reference's debugging switches and synthetic input (config.h:
    # 131), kept with JAX's defaults for the scripts that read them;
    # nothing in either package does
    profiling: bool = False
    log_instance_creation: bool = False
    synthetic_input: bool = False

    # observability (utils/telemetry.py): telemetry turns the event bus
    # on; trace_out (a Chrome trace written after every generate() and
    # fit()), metrics_port (a /metrics endpoint; 0 = an ephemeral port)
    # and postmortem_dir (bounded failure bundles) each turn it on too.
    # trace_dir is where utils/profiling.trace() writes the profiler's
    # trace (None = DEFAULT_TRACE_DIR)
    telemetry: bool = False
    trace_out: Optional[str] = None
    telemetry_buffer_events: int = 65536
    telemetry_drift_threshold: float = 0.5
    metrics_port: Optional[int] = None
    metrics_host: str = "127.0.0.1"
    postmortem_dir: Optional[str] = None
    postmortem_events: int = 2048
    trace_dir: Optional[str] = None
    # the SLO burn monitor's tolerated violation fraction (utils/slo.py)
    slo_error_budget: float = 0.01
    slo_monitor: bool = True

    # fit's dispatch window (core/overlap.py DispatchWindow): up to this
    # many train dispatches in flight before the oldest one's metrics
    # are fetched; 1 = synchronous, 0 = unbounded (fetch at epoch end)
    train_dispatch_depth: int = 2

    # recompute each weighted op's activations in the backward
    # (torch.utils.checkpoint), as the JAX executor's jax.checkpoint
    remat: bool = False
    # run sibling convs (one input, one geometry: Inception's 1x1
    # branch heads) as one conv (core/fusion.py)
    sibling_conv_fusion: bool = True
    # "NHWC": conv, pool and batch-norm values stay in channels_last
    # memory between those ops (core/executor.py); shapes stay NCHW
    conv_layout: str = "NCHW"
    # the strategy search (search/mcmc.py, the JAX package's fields and
    # defaults). compile(search_budget > 0) runs it; without a mesh (one
    # device) the model's strategy stays as it is, as in JAX.
    # search_chains 0 = min(4, cpu_count) parallel annealing chains;
    # search_delta_sim re-simulates only the moved op per proposal;
    # search_overlap_backward_sync lets gradient syncs overlap the
    # backward (bucket-granular when grad_bucket_mb > 0);
    # search_mesh_shapes searches the mesh factorization too
    search_budget: int = 0
    search_alpha: float = 0.05
    search_overlap_backward_sync: bool = True
    search_delta_sim: bool = True
    search_chains: int = 0
    search_mesh_shapes: bool = False
    # strategy files (parallel/pconfig.Strategy JSON, or the reference's
    # text or .pb formats on import)
    import_strategy_file: Optional[str] = None
    export_strategy_file: Optional[str] = None
    # the search's gates: which logical axes its candidates may map
    enable_sample_parallel: bool = True
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    enable_sequence_parallel: bool = False
    enable_expert_parallel: bool = False
    enable_pipeline_parallel: bool = False
    enable_propagation: bool = False
    enable_device_placement: bool = False
    # sequence-parallel attention lowering the cost model prices
    # (parallel/ulysses.sp_mode_for): "auto", "ring" or "alltoall"
    sp_attention: str = "auto"
    # ground the top-N ops (by analytic time) in measurements on the
    # card (search/op_measure.py); 0 = analytic only
    measure_top_ops: int = 0
    # DOT export of the simulated task graph, and the Perfetto export
    # of the winning strategy's simulated schedule
    taskgraph_file: Optional[str] = None
    schedule_trace_file: Optional[str] = None
    # gradient-sync bucket size (core/overlap.py resolve_bucket_mb),
    # priced by the simulator and executed on a mesh's data axis: 0 =
    # one all-reduce after the backward, None = auto from the machine
    # model. On one device there is no sync to bucket
    grad_bucket_mb: Optional[float] = None
    # ZeRO-1: split the dense parameters' optimizer slots over the
    # `data` axis of an executing mesh (core/executor.py); warns and
    # does nothing on a mesh without a data axis of several ranks
    zero_optimizer_sharding: bool = False
    # pipelines (parallel/graph_pipeline.py): the simulator prices them
    # and compile executes them on a mesh with a non-data axis of the
    # stage count (core/staged.py)
    pipeline_stages: int = 0
    pipeline_microbatches: int = 4
    pipeline_schedule: str = "gpipe"
    pipeline_virtual_stages: int = 1
    # fusion groups (core/fusion.py): the simulator costs a
    # same-strategy chain as one task; on one device the executor runs
    # the same ops either way
    perform_fusion: bool = False
    # mesh (parallel/mesh.make_mesh): None = one device; a mesh of
    # several devices executes on a process group of its size (axes
    # default to data, model, seq, expert, pipe in order)
    mesh_shape: Optional[Sequence[int]] = None
    mesh_axes: Optional[Sequence[str]] = None
    iter_config: FFIterationConfig = dataclasses.field(
        default_factory=FFIterationConfig)
    # flags to parse at construction (parse_args); None leaves the
    # process's argv alone, as a library must. A training or serving
    # script calls FFConfig.from_args(). Consumed there (reset to None),
    # so that a dataclasses.replace of the config (a serving role's, a
    # replica's) does not parse the flags again over the fields it
    # replaces
    argv: Optional[Sequence[str]] = None

    def __post_init__(self):
        if self.argv is not None:
            self.parse_args(self.argv)
            self.argv = None
        self.validate()

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None
                  ) -> "FFConfig":
        """The config of a training or serving script: its command
        line parsed (``sys.argv[1:]`` unless ``argv`` is given)."""
        return cls(argv=list(sys.argv[1:]) if argv is None
                   else list(argv))

    # the reference's flags (FFConfig::parse_args, model.cc:2258-2379)
    # and the JAX package's, JAX's three tables: flag -> (field, type)
    _FLAG_MAP = {
        "-b": ("batch_size", int),
        "--batch-size": ("batch_size", int),
        "-e": ("epochs", int),
        "--epochs": ("epochs", int),
        "--iterations": ("iterations", int),
        "-lr": ("learning_rate", float),
        "--learning-rate": ("learning_rate", float),
        "-wd": ("weight_decay", float),
        "--weight-decay": ("weight_decay", float),
        "--search-budget": ("search_budget", int),
        "--budget": ("search_budget", int),
        "--search-alpha": ("search_alpha", float),
        "--alpha": ("search_alpha", float),
        "--search-chains": ("search_chains", int),
        "--cost-cache": ("cost_cache_file", str),
        "--import": ("import_strategy_file", str),
        "--import-strategy": ("import_strategy_file", str),
        "--export": ("export_strategy_file", str),
        "--export-strategy": ("export_strategy_file", str),
        "--machine-model-file": ("machine_model_file", str),
        "--taskgraph": ("taskgraph_file", str),
        "--seed": ("seed", int),
        "--grad-bucket-mb": ("grad_bucket_mb", float),
        "--train-dispatch-depth": ("train_dispatch_depth", int),
        "--compute-dtype": ("compute_dtype", str),
        "--param-dtype": ("param_dtype", str),
        "--conv-layout": ("conv_layout", str),
        "--measure-ops": ("measure_top_ops", int),
        "--moe-dispatch": ("moe_dispatch", str),
        "--sp-attention": ("sp_attention", str),
        "--pipeline-stages": ("pipeline_stages", int),
        "--pipeline-microbatches": ("pipeline_microbatches", int),
        "--pipeline-schedule": ("pipeline_schedule", str),
        "--pipeline-virtual-stages": ("pipeline_virtual_stages", int),
        "--kv-page-size": ("kv_page_size", int),
        "--kv-num-pages": ("kv_num_pages", int),
        "--kv-dtype": ("kv_dtype", str),
        "--kv-pool-mb": ("kv_pool_mb", float),
        "--host-tier-mb": ("host_tier_mb", float),
        "--program-cache-dir": ("program_cache_dir", str),
        "--serve-attn-block-kv": ("serve_attn_block_kv", int),
        "--serve-max-seqs": ("serve_max_seqs", int),
        "--serve-prefill-budget": ("serve_prefill_budget", int),
        "--adapter-rank": ("adapter_rank", int),
        "--adapter-pool-mb": ("adapter_pool_mb", float),
        "--tenant-adapters": ("tenant_adapters", int),
        "--serve-admit-watermark": ("serve_admit_watermark", float),
        "--spec-tokens": ("serve_spec_tokens", int),
        "--fault-spec": ("fault_spec", str),
        "--request-deadline": ("serve_request_deadline", float),
        "--serve-max-retries": ("serve_max_retries", int),
        "--serve-retry-backoff": ("serve_retry_backoff_s", float),
        "--serve-reject-stalls": ("serve_reject_stalls", int),
        "--serve-mesh": ("serve_mesh", str),
        "--serve-disagg-ratio": ("serve_disagg_ratio", str),
        "--serve-disagg-decode-budget": ("serve_disagg_decode_budget",
                                         int),
        "--serve-replicas": ("serve_replicas", _int_or_auto),
        "--router-policy": ("router_policy", str),
        "--slo-ttft-ms": ("slo_ttft_ms", float),
        "--slo-tpot-ms": ("slo_tpot_ms", float),
        "--autoscale-max": ("serve_autoscale_max", int),
        "--transport": ("serve_transport", str),
        "--transport-host": ("serve_transport_host", str),
        "--transport-port": ("serve_transport_port", int),
        "--trace-out": ("trace_out", str),
        "--trace-dir": ("trace_dir", str),
        "--telemetry-buffer": ("telemetry_buffer_events", int),
        "--drift-threshold": ("telemetry_drift_threshold", float),
        "--metrics-port": ("metrics_port", int),
        "--metrics-host": ("metrics_host", str),
        "--schedule-trace": ("schedule_trace_file", str),
        "--postmortem-dir": ("postmortem_dir", str),
        "--postmortem-events": ("postmortem_events", int),
        "--slo-error-budget": ("slo_error_budget", float),
    }
    # flag -> field set True
    _BOOL_FLAGS = {
        "--profiling": "profiling",
        "--fusion": "perform_fusion",
        "--remat": "remat",
        "--overlap": "search_overlap_backward_sync",
        "--enable-parameter-parallel": "enable_parameter_parallel",
        "--enable-attribute-parallel": "enable_attribute_parallel",
        "--enable-sample-parallel": "enable_sample_parallel",
        "--enable-sequence-parallel": "enable_sequence_parallel",
        "--enable-expert-parallel": "enable_expert_parallel",
        "--enable-pipeline-parallel": "enable_pipeline_parallel",
        "--enable-propagation": "enable_propagation",
        "--search-mesh-shapes": "search_mesh_shapes",
        "--enable-device-placement": "enable_device_placement",
        "--zero": "zero_optimizer_sharding",
        "--synthetic-input": "synthetic_input",
        "--sparse-embedding-lazy": "sparse_embedding_lazy",
        "--telemetry": "telemetry",
        "--serve-disagg": "serve_disagg",
        "--autoscale": "serve_autoscale",
        "--wall-clock": "serve_wall_clock",
    }
    # flag -> field set False
    _NEG_BOOL_FLAGS = {
        "--no-overlap-sync": "search_overlap_backward_sync",
        "--no-sparse-embedding": "sparse_embedding_updates",
        "--no-sibling-conv-fusion": "sibling_conv_fusion",
        "--no-delta-sim": "search_delta_sim",
        "--no-cost-cache": "search_cost_cache",
        "--no-chunked-prefill": "serve_chunked_prefill",
        "--no-prefix-cache": "serve_prefix_cache",
        "--no-host-tier": "serve_host_tier",
        "--no-spec-decode": "serve_spec_decode",
        "--no-degrade-ladder": "serve_degrade_ladder",
        "--no-search-trace": "search_trace",
        "--no-slo-monitor": "slo_monitor",
    }

    def parse_args(self, argv: Sequence[str]) -> None:
        """Set the fields the flags of ``argv`` name (JAX's tables and
        ``--seq-length``); any other argument is skipped, as in JAX. A
        value flag at the end of ``argv``, with no value, is skipped
        too. Call :meth:`validate` after a direct call; construction
        does."""
        i = 0
        argv = list(argv)
        while i < len(argv):
            a = argv[i]
            if a in self._FLAG_MAP and i + 1 < len(argv):
                field, typ = self._FLAG_MAP[a]
                setattr(self, field, typ(argv[i + 1]))
                i += 2
                continue
            if a in self._BOOL_FLAGS:
                setattr(self, self._BOOL_FLAGS[a], True)
                i += 1
                continue
            if a in self._NEG_BOOL_FLAGS:
                setattr(self, self._NEG_BOOL_FLAGS[a], False)
                i += 1
                continue
            if a == "--seq-length" and i + 1 < len(argv):
                self.iter_config.seq_length = int(argv[i + 1])
                i += 2
                continue
            i += 1

    # -- the job's devices, read where parallel/mesh.serve_devices reads
    @property
    def num_devices(self) -> int:
        """The job's devices: the running process group's world size
        (one card, or one CPU process, a rank), else the visible cards
        (at least 1)."""
        from .parallel.mesh import serve_devices
        return serve_devices()

    @property
    def workers_per_node(self) -> int:
        """The devices of this node: in a process group its ranks on
        this node (torchrun's ``LOCAL_WORLD_SIZE``; every rank when it
        is unset, ranks launched on one machine), else the visible
        cards (at least 1)."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            world = int(dist.get_world_size())
            return max(1, min(world, int(os.environ.get(
                "LOCAL_WORLD_SIZE", world))))
        return max(1, torch.cuda.device_count())

    @property
    def num_nodes(self) -> int:
        """The job's nodes: its devices over the devices of a node."""
        return max(1, self.num_devices // self.workers_per_node)

    def validate(self) -> None:
        """Normalize the precision policy to torch dtypes (names such
        as "bfloat16" are taken) and reject values a step would
        silently ignore. Called at construction and from compile."""
        self.compute_dtype = resolve_dtype(self.compute_dtype,
                                           "compute_dtype")
        self.param_dtype = resolve_dtype(self.param_dtype, "param_dtype")
        if self.batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1, got {self.batch_size}")
        if self.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")
        if self.kv_page_size < 1:
            raise ValueError(
                f"kv_page_size must be >= 1, got {self.kv_page_size}")
        if self.kv_num_pages < 2:
            raise ValueError(
                f"kv_num_pages must be >= 2 (page 0 is the serving "
                f"sink page), got {self.kv_num_pages}")
        if self.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"pipeline_schedule must be 'gpipe' or '1f1b', got "
                f"{self.pipeline_schedule!r}")
        if self.sp_attention not in ("auto", "ring", "alltoall"):
            raise ValueError(
                f"sp_attention must be 'auto', 'ring' or 'alltoall', "
                f"got {self.sp_attention!r}")
        if self.pipeline_virtual_stages < 1:
            raise ValueError(
                f"pipeline_virtual_stages must be >= 1, got "
                f"{self.pipeline_virtual_stages}")
        if self.grad_bucket_mb is not None and self.grad_bucket_mb < 0:
            raise ValueError(
                f"grad_bucket_mb must be >= 0 (0 = monolithic sync, "
                f"unset = auto-tune), got {self.grad_bucket_mb}")
        if self.search_chains < 0:
            raise ValueError(
                f"search_chains must be >= 0 (0 = auto), got "
                f"{self.search_chains}")
        if self.pipeline_virtual_stages > 1 \
                and self.pipeline_schedule != "1f1b":
            raise ValueError(
                "pipeline_virtual_stages > 1 requires "
                "pipeline_schedule='1f1b' (interleaving lives in the "
                "explicit-gradient schedule)")
        if self.conv_layout not in ("NCHW", "NHWC"):
            raise ValueError(
                f"conv_layout must be 'NCHW' or 'NHWC', got "
                f"{self.conv_layout!r}")
        if self.moe_dispatch not in ("auto", "dense", "sorted"):
            raise ValueError(
                f"moe_dispatch must be 'auto', 'dense' or 'sorted', "
                f"got {self.moe_dispatch!r}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, "
                f"got {self.kv_dtype!r}")
        if self.kv_pool_mb < 0:
            raise ValueError(
                f"kv_pool_mb must be >= 0 (0 = size by kv_num_pages), "
                f"got {self.kv_pool_mb}")
        if self.host_tier_mb < 0:
            raise ValueError(
                f"host_tier_mb must be >= 0 (0 = host tier unarmed), "
                f"got {self.host_tier_mb}")
        if self.serve_attn_block_kv < 0:
            raise ValueError(
                f"serve_attn_block_kv must be >= 0 (0 = default), "
                f"got {self.serve_attn_block_kv}")
        if self.serve_max_seqs < 1:
            raise ValueError(
                f"serve_max_seqs must be >= 1, got {self.serve_max_seqs}")
        if self.serve_prefill_budget < 1:
            raise ValueError(
                f"serve_prefill_budget must be >= 1, got "
                f"{self.serve_prefill_budget}")
        if self.adapter_rank < 0:
            raise ValueError(
                f"adapter_rank must be >= 0 (0 = adapters unarmed), "
                f"got {self.adapter_rank}")
        if self.adapter_pool_mb < 0:
            raise ValueError(
                f"adapter_pool_mb must be >= 0 (0 = size by "
                f"serve_max_seqs), got {self.adapter_pool_mb}")
        if self.tenant_adapters < 0:
            raise ValueError(
                f"tenant_adapters must be >= 0, got "
                f"{self.tenant_adapters}")
        if self.adapter_rank > 0 and not self.serve_chunked_prefill:
            raise ValueError(
                "adapter_rank > 0 needs chunked prefill (the per-lane "
                "adapter gather lives in the one mixed step)")
        if not 0.0 <= self.serve_admit_watermark < 1.0:
            raise ValueError(
                f"serve_admit_watermark must be in [0, 1), got "
                f"{self.serve_admit_watermark}")
        if self.serve_spec_tokens < 0:
            raise ValueError(
                f"serve_spec_tokens must be >= 0 (0 disables "
                f"speculative decoding), got {self.serve_spec_tokens}")
        if self.serve_reject_stalls < 0:
            raise ValueError(
                f"serve_reject_stalls must be >= 0 (0 = never), got "
                f"{self.serve_reject_stalls}")
        if self.train_dispatch_depth < 0:
            raise ValueError(
                f"train_dispatch_depth must be >= 0 (0 = unbounded, "
                f"1 = synchronous), got {self.train_dispatch_depth}")
        if self.serve_request_deadline < 0:
            raise ValueError(
                f"serve_request_deadline must be >= 0 (0 = none), got "
                f"{self.serve_request_deadline}")
        if self.serve_max_retries < 0:
            raise ValueError(
                f"serve_max_retries must be >= 0, got "
                f"{self.serve_max_retries}")
        if self.serve_retry_backoff_s < 0:
            raise ValueError(
                f"serve_retry_backoff_s must be >= 0, got "
                f"{self.serve_retry_backoff_s}")
        if self.telemetry_buffer_events < 1:
            raise ValueError(
                f"telemetry_buffer_events must be >= 1, got "
                f"{self.telemetry_buffer_events}")
        if self.telemetry_drift_threshold < 0:
            raise ValueError(
                f"telemetry_drift_threshold must be >= 0, got "
                f"{self.telemetry_drift_threshold}")
        if self.metrics_port is not None and not (
                0 <= int(self.metrics_port) <= 65535):
            raise ValueError(
                f"metrics_port must be None (off) or 0..65535 "
                f"(0 = ephemeral), got {self.metrics_port}")
        if self.postmortem_events < 1:
            raise ValueError(
                f"postmortem_events must be >= 1, got "
                f"{self.postmortem_events}")
        if not (0.0 < self.slo_error_budget <= 1.0):
            raise ValueError(
                f"slo_error_budget must be in (0, 1] (the tolerated "
                f"violation fraction), got {self.slo_error_budget}")
        if isinstance(self.serve_replicas, str):
            if self.serve_replicas.strip() != "auto":
                raise ValueError(
                    f"serve_replicas must be an integer >= 1 or "
                    f"'auto', got {self.serve_replicas!r}")
        elif self.serve_replicas < 1:
            raise ValueError(
                f"serve_replicas must be >= 1, got "
                f"{self.serve_replicas}")
        if self.router_policy not in ("affinity", "round_robin"):
            raise ValueError(
                f"router_policy must be 'affinity' or 'round_robin', "
                f"got {self.router_policy!r}")
        if self.slo_ttft_ms < 0 or self.slo_tpot_ms < 0:
            raise ValueError(
                f"slo_ttft_ms/slo_tpot_ms must be >= 0 (0 = no "
                f"bound), got {self.slo_ttft_ms}/{self.slo_tpot_ms}")
        if self.serve_autoscale_max < 0:
            raise ValueError(
                f"serve_autoscale_max must be >= 0 (0 = 2x "
                f"serve_replicas), got {self.serve_autoscale_max}")
        sr = str(self.serve_disagg_ratio or "").strip()
        if sr and sr != "auto":
            parts = sr.split(":")
            ok = len(parts) == 2
            if ok:
                try:
                    ok = int(parts[0]) >= 1 and int(parts[1]) >= 1
                except ValueError:
                    ok = False
            if not ok:
                raise ValueError(
                    f"serve_disagg_ratio must be '', 'auto', or "
                    f"'P:D' with positive engine counts, got "
                    f"{self.serve_disagg_ratio!r}")
        if self.serve_disagg_decode_budget < 0:
            raise ValueError(
                f"serve_disagg_decode_budget must be >= 0 (0 = two "
                f"pages' worth), got {self.serve_disagg_decode_budget}")
        if str(self.serve_transport or "").strip() not in ("", "tcp"):
            raise ValueError(
                f"serve_transport must be '' (in-process) or 'tcp', "
                f"got {self.serve_transport!r}")
        if not 0 <= int(self.serve_transport_port) <= 65535:
            raise ValueError(
                f"serve_transport_port must be 0..65535 (0 = "
                f"ephemeral), got {self.serve_transport_port}")
        sm = str(self.serve_mesh or "").strip()
        if sm and sm != "auto":
            try:
                ok = int(sm) >= 1
            except ValueError:
                ok = False
            if not ok:
                raise ValueError(
                    f"serve_mesh must be '', 'auto', or a positive "
                    f"tensor-parallel degree, got {self.serve_mesh!r}")
        if self.serve_wall_clock and self.serve_autoscale:
            raise ValueError(
                "serve_wall_clock and serve_autoscale are mutually "
                "exclusive: the autoscaler replays on the virtual "
                "clock only")
        if self.fault_spec:
            # parse now, so that a mistyped spec fails here and not in
            # the middle of a chaos run
            FaultSpec(self.fault_spec)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asked
    for the CPU. Raises when CUDA is asked for and absent — a run on
    the CPU is only ever one the caller chose.

    On CUDA this also turns TF32 off for float32 matmuls and
    convolutions, mirroring the JAX package's float32 matmul precision
    (``jax_default_matmul_precision=float32`` in its tests): an f32
    engine computes in full f32, so its tokens are comparable with the
    reference's. It also keeps bf16 matmul reductions in f32
    (``allow_bf16_reduced_precision_reduction`` off), the JAX ops'
    ``preferred_element_type=float32``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for but CUDA is not available "
                f"(pass device='cpu' to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul \
            .allow_bf16_reduced_precision_reduction = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def torch_dtype(dtype) -> Optional[torch.dtype]:
    """The torch dtype of ``dtype``: a torch dtype as it is, a name
    (``"int32"``, ``"bfloat16"``), or anything ``np.dtype`` reads — a
    numpy dtype or scalar type, or a JAX one such as ``jnp.int32`` (it
    carries its numpy dtype), so a frontend that passes JAX's dtypes
    builds the same tensors. None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        named = getattr(torch, dtype.replace("torch.", ""), None)
        if isinstance(named, torch.dtype):
            return named
    try:
        return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype
    except TypeError as e:
        raise TypeError(f"no torch dtype for {dtype!r}") from e
