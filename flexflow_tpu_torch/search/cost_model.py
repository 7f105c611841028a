"""Serve-program pricing: the serve half of
``flexflow_tpu/search/cost_model.py``.

The ONE mixed prefill+decode serving step as a task graph priced on the
machine model's roofline and collective formulas — the JAX package's
formulas, line for line, so that on the same machine numbers both
packages price the same seconds. ``op_cost`` and the pipeline costs of
the training search come with its port (ROADMAP module item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .machine_model import H100MachineModel

# bump when any cost formula changes: part of the persistent cost-cache
# fingerprint (search/cost_cache.py). The JAX package's version of the
# same formulas (v6: serve pricing with the disaggregated handoff link
# and LoRA adapters)
COST_MODEL_VERSION = 6


@dataclasses.dataclass
class OpCost:
    """One cached cost row (the JAX package's OpCost fields): the serve
    placement search stores its step prices in these slots
    (search/serve_place.py says which). The training search's per-op
    costs come with its port."""
    fwd: float
    bwd: float
    fwd_comm: float
    bwd_comm: float
    sync: float
    mem: float
    update: float = 0.0
    sync_bytes: float = 0.0
    pipeline: Optional[object] = None


# the serve mesh's one axis name (parallel/mesh.TENSOR)
SERVE_AXIS = "tensor"


@dataclasses.dataclass(frozen=True)
class ServeArch:
    """What the placement search needs to know about one ServeEngine:
    the LM's dimensions plus the serving workload's steady state. Built
    by ``ServeEngine.serve_arch()``; priced by :func:`serve_step_tasks`
    per tensor-parallel degree. ``context`` is the assumed resident
    KV history per decode lane (the attention/KV-streaming term);
    ``decode_lanes``/``prefill_lanes`` are the two steady-state
    workloads the ONE mixed program alternates between — a full decode
    step and a budget-sized prefill chunk."""

    num_layers: int
    hidden: int
    num_heads: int
    head_dim: int
    ff_dim: int
    vocab: int
    decode_lanes: int = 8
    prefill_lanes: int = 512
    context: int = 1024
    # steady-state output length per request — the decode-side work a
    # disaggregated ratio search balances against one prompt's prefill
    # chunks + page handoff (optimize_serve_disagg)
    decode_tokens: int = 64
    # the disaggregated decode role's prefill-lane stub (the cluster's
    # serve_disagg_decode_budget, default two pages): its fixed
    # program dispatches decode_lanes + THIS many lanes every step, so
    # the ratio search must price that width, not bare decode_lanes
    handoff_stub_lanes: int = 32
    # multi-tenant LoRA pool (serve/adapters.py): the fixed slab rank
    # and the pool's slot count (0 = adapters unarmed). Both are
    # signature() fields, so arming adapters — or resizing the pool —
    # is a guaranteed cost-cache miss.
    adapter_rank: int = 0
    adapter_slots: int = 0
    kv_dtype: str = "float32"
    kv_itemsize: float = 4.0
    kv_scales: bool = False      # quantized pools stream f32 scale rows
    act_itemsize: float = 4.0
    act_dtype: str = "float32"
    param_itemsize: float = 4.0  # serving weights as resident on device

    def signature(self) -> tuple:
        """Stable tuple of every field the pricing reads — the
        cost-cache entry key half (serve_place folds it in), so an
        arch OR kv/act dtype flip is a guaranteed cache miss."""
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self))

    def weight_bytes(self) -> float:
        """Total LM weight bytes at param_itemsize (qkv + wo + ffn per
        layer, tied-vocab embedding + head)."""
        e, hd = self.hidden, self.num_heads * self.head_dim
        per_layer = 3 * e * hd + hd * e + 2 * e * self.ff_dim
        return (self.num_layers * per_layer + 2 * self.vocab * e) \
            * self.param_itemsize


@dataclasses.dataclass
class ServeTask:
    """One node of the serve-step task graph (the serving analog of
    the training simulator's _Task): compute tasks run on the matmul/HBM
    roofline, collective tasks on the ring formulas. deps name
    earlier tasks; simulator.simulate_serve_tasks runs the critical
    path."""
    name: str
    kind: str            # "compute" | "collective"
    seconds: float
    deps: tuple = ()


def kv_handoff_bytes(arch: ServeArch,
                     tokens: Optional[int] = None) -> float:
    """Host-link bytes of ONE prefill->decode page handoff: `tokens`
    (default: the arch's steady-state context) of K and V across every
    layer at the PAGE STORAGE dtype's itemsize, plus the f32 per-row
    scale arrays on quantized pools — exactly what
    ServeEngine.export_kv ships (serve/disagg.py). This is the term
    that makes a KV-dtype flip change the priced transfer cost: int8
    pages cost ~1/4 the f32 bytes on the link, the same 4x lever they
    are in HBM."""
    n = max(1, int(arch.context if tokens is None else tokens))
    hd = arch.num_heads * arch.head_dim
    b = 2.0 * n * hd * arch.num_layers * arch.kv_itemsize
    if arch.kv_scales:
        b += 2.0 * n * arch.num_heads * arch.num_layers * 4.0
    return b


def serve_step_tasks(arch: ServeArch, tensor_parallel: int,
                     mm: H100MachineModel, *, lanes: int,
                     axis: str = SERVE_AXIS,
                     transfer_tokens: int = 0) -> list:
    """Task graph of ONE mixed serving step with ``lanes`` query lanes
    sharded ``tensor_parallel`` ways on the serve mesh, priced exactly like the engine executes it:

      per layer — head-column-parallel qkv, paged attention over each
      lane's ``context`` KV at ``kv_itemsize`` (plus f32 scale rows on
      quantized pools), head-row-parallel wo with its all-reduce,
      column→row-parallel FFN with its all-reduce; then the
      vocab-sharded head with the program's ONE logits all-gather
      (the embedding psum rides the first layer's entry).

    Weights stream at ``param_itemsize`` (serving is small-batch: the
    HBM weight traffic is the t× lever), activations/collectives at
    ``act_itemsize``. Returns [ServeTask] in dependency order.

    ``transfer_tokens`` > 0 adds the disaggregated page-handoff link:
    a ``kv_handoff`` task of kind "transfer" pricing that many tokens'
    KV pages over the host link (:func:`kv_handoff_bytes` at the KV
    storage itemsize + scale rows). It carries NO deps — the host-side
    DMA runs beside the device step, so it lengthens the makespan only
    when the link, not the compute, is the bottleneck (exactly how a
    decode engine imports one request's pages while decoding the
    others)."""
    t = max(1, int(tensor_parallel))
    T = int(lanes)
    e, h, d, f = arch.hidden, arch.num_heads, arch.head_dim, arch.ff_dim
    hd = h * d
    act = arch.act_itemsize
    p = arch.param_itemsize
    ctx = max(1, int(arch.context))
    dt = arch.act_dtype
    tasks: list = []

    def compute(name, flops, bytes_moved, deps):
        tasks.append(ServeTask(
            name, "compute",
            mm.compute_time(flops, bytes_moved, True, dtype=dt),
            deps))

    def all_reduce(name, nbytes, deps):
        if t > 1:
            tasks.append(ServeTask(
                name, "collective", mm.all_reduce(nbytes, t, axis),
                deps))

    # multi-tenant LoRA deltas (serve/adapters.py): every lane gathers
    # its tenant's (A, B) slabs by slot index and adds
    # (x @ A) @ B * scale on each adapted projection. The gather's HBM
    # traffic streams at most min(lanes, slots) distinct slots' slabs
    # (the A factors and replicated-output B factors replicate; the
    # head/ff-sharded factors divide by t); the delta flops ride the
    # projection tasks they extend.
    r = max(0, int(arch.adapter_rank))
    lora_qkv = lora_wo = lora_ffn = 0.0
    if r > 0:
        n_ad = min(T, max(1, int(arch.adapter_slots)))
        rep_slab = arch.num_layers * (3 * e * r + 3 * r * e) * act
        shd_slab = arch.num_layers * (3 * r * hd + hd * r
                                      + r * f + f * r) * act / t
        lora_qkv = 3 * (2 * T * e * r + 2 * T * r * hd / t)
        lora_wo = 2 * T * (hd / t) * r + 2 * T * r * e
        lora_ffn = (2 * T * e * r + 2 * T * r * f / t
                    + 2 * T * (f / t) * r + 2 * T * r * e)
    # vocab-row-sharded embedding: gather T rows locally, ONE exact
    # psum assembles them (engine._embed_tp)
    compute("embed", 0.0, T * e * act, ())
    all_reduce("embed_psum", T * e * act, ("embed",))
    prev = tasks[-1].name
    if r > 0:
        compute("adapter_gather", 0.0, n_ad * (rep_slab + shd_slab),
                (prev,))
        prev = "adapter_gather"
    for i in range(arch.num_layers):
        # head-column-parallel qkv (each device its H/t heads)
        compute(f"l{i}.qkv", 2 * 3 * T * e * hd / t + lora_qkv,
                (3 * e * hd * p) / t + T * e * act
                + 3 * T * hd * act / t, (prev,))
        # paged ragged attention: QK^T + PV over each lane's context,
        # streaming the head shard of the KV pages (+ scale rows on
        # quantized pools)
        kv_bytes = 2 * T * ctx * (hd / t) * arch.kv_itemsize
        if arch.kv_scales:
            kv_bytes += 2 * T * ctx * (h / t) * 4.0
        compute(f"l{i}.attn", 4 * T * ctx * hd / t, kv_bytes,
                (f"l{i}.qkv",))
        # head-row-parallel wo: partial sums complete in the all-reduce
        compute(f"l{i}.wo", 2 * T * hd * e / t + lora_wo,
                (hd * e * p) / t + T * e * act, (f"l{i}.attn",))
        all_reduce(f"l{i}.ar_attn", T * e * act, (f"l{i}.wo",))
        # column->row-parallel FFN, one all-reduce before the bias
        compute(f"l{i}.ffn", 2 * 2 * T * e * f / t + lora_ffn,
                (2 * e * f * p) / t + 2 * T * e * act,
                (tasks[-1].name,))
        all_reduce(f"l{i}.ar_ffn", T * e * act, (f"l{i}.ffn",))
        prev = tasks[-1].name
    # vocab-column-sharded head + the program's only all-gather
    compute("head", 2 * T * e * arch.vocab / t,
            (e * arch.vocab * p) / t + T * e * act, (prev,))
    if t > 1:
        tasks.append(ServeTask(
            "logits_gather", "collective",
            mm.all_gather(T * arch.vocab * act, t, axis), ("head",)))
    if transfer_tokens > 0:
        tasks.append(ServeTask(
            "kv_handoff", "transfer",
            mm.host_transfer(kv_handoff_bytes(arch,
                                              int(transfer_tokens))),
            ()))
    return tasks


def serve_device_bytes(arch: ServeArch, tensor_parallel: int) -> float:
    """Per-device resident bytes under head/vocab sharding: the weight
    shard plus each decode lane's context KV shard plus the LoRA
    adapter pool — what the memory penalty (and the auto placement's
    HBM fit) sees. The adapter term mirrors AdapterConfig.
    pool_device_bytes (serve/adapters.py): per slot, the replicated
    A / output-B factors plus the head/ff-sharded factors over t, at
    the activation itemsize, plus the f32 scale."""
    t = max(1, int(tensor_parallel))
    kv = (2 * arch.decode_lanes * arch.context
          * (arch.num_heads * arch.head_dim / t) * arch.num_layers
          * arch.kv_itemsize)
    if arch.kv_scales:
        kv += (2 * arch.decode_lanes * arch.context
               * (arch.num_heads / t) * arch.num_layers * 4.0)
    adapters = 0.0
    r = max(0, int(arch.adapter_rank))
    if r > 0 and arch.adapter_slots > 0:
        e, f = arch.hidden, arch.ff_dim
        hd = arch.num_heads * arch.head_dim
        rep = arch.num_layers * (3 * e * r + 3 * r * e)
        shd = arch.num_layers * (3 * r * hd + hd * r + r * f + f * r)
        adapters = arch.adapter_slots * (
            (rep + shd / t) * arch.act_itemsize + 4.0)
    return arch.weight_bytes() / t + kv + adapters
