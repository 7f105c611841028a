"""Cost model of the search: ``flexflow_tpu/search/cost_model.py``,
both halves.

The training half prices one op under one op strategy on a mesh
description (``op_cost``: the roofline and collective formulas of the
machine model, with embeddings sparse or dense, device placement,
tensor, sequence (per ``parallel/ulysses.sp_mode_for``), expert and
pipeline parallelism, the data-parallel gradient sync and the optimizer
sweep), and a graph-level staged pipeline (``staged_pipeline_cost``).
The serve half prices the ONE mixed prefill+decode serving step as a
task graph. Both are the JAX package's formulas, line for line, run as
the same Python float operations in the same order, so that on the same
machine numbers both packages price the same seconds. Dtypes are priced
by the JAX package's names (``core/precision.dtype_name``), so a price
and a cache fingerprint mean the same thing in both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.precision import dtype_name
from ..op import Op
from ..parallel.pconfig import OpStrategy
from .machine_model import H100MachineModel

# bump when any cost formula changes: part of the persistent cost-cache
# fingerprint (search/cost_cache.py). The JAX package's version of the
# same formulas (v6: serve pricing with the disaggregated handoff link
# and LoRA adapters)
COST_MODEL_VERSION = 6

BWD_FLOP_FACTOR = 2.0  # dX and dW GEMMs ≈ 2x fwd (reference bwd = 2 GEMMs)
# per-op-type overrides: attention bwd recomputes probabilities from the
# saved logsumexp (flash custom-VJP) + 4 grad einsums ≈ 4x fwd
BWD_FACTOR_BY_TYPE = {"multihead_attention": 4.0}
MATMUL_OPS = {"linear", "conv2d", "batch_matmul", "multihead_attention",
              "lstm", "moe_ffn", "pipeline_blocks"}


@dataclasses.dataclass
class PipelineCost:
    """Per-stage costs for event-loop expansion of a pipelined op
    (reference simulator.cc:330-629 expands every task; our Python
    simulator expands pipeline units into (microbatch, stage) tasks).

    Uniform stages (pipeline_blocks) use the scalar fields; graph-level
    staged strategies (heterogeneous stages, core/staged.py) fill the
    per-stage/per-cut lists instead."""
    stages: int
    microbatches: int
    fwd_stage: float    # compute seconds of ONE (microbatch, stage) tick
    bwd_stage: float
    hop: float          # ppermute seconds per inter-stage activation hop
    fwd_stages: Optional[list] = None   # per-stage overrides
    bwd_stages: Optional[list] = None
    hops: Optional[list] = None         # per-cut overrides (len S-1)

    def fwd_at(self, k: int) -> float:
        return self.fwd_stages[k] if self.fwd_stages else self.fwd_stage

    def bwd_at(self, k: int) -> float:
        return self.bwd_stages[k] if self.bwd_stages else self.bwd_stage

    def hop_at(self, k: int) -> float:
        """Hop cost of the cut feeding stage k (k >= 1)."""
        return self.hops[k - 1] if self.hops else self.hop


@dataclasses.dataclass
class OpCost:
    """One op's price under one op strategy (the JAX package's fields);
    the serve placement search stores its step prices in the same slots
    (search/serve_place.py says which)."""
    fwd: float          # compute seconds, sharded
    bwd: float
    fwd_comm: float     # collective seconds attributable to fwd
    bwd_comm: float
    sync: float         # gradient sync (DP all-reduce) seconds
    mem: float          # bytes resident per device (weights+opt+acts)
    # optimizer-update sweep seconds (HBM-bound; the reference's update
    # tasks carry run_time=0, simulator.cc:420 — priced here beyond
    # parity). Kept separate from bwd so measured grounding replaces
    # kernel time without losing the update term; task builders add
    # bwd + update.
    update: float = 0.0
    # per-device bytes this op contributes to the DP gradient all-reduce
    # (the payload behind `sync`); 0 when no data-axis sync exists. The
    # simulator sums these over a bucket's members to price ONE combined
    # all-reduce per bucket (grad_bucket_mb) — real per-bucket
    # latency+bandwidth instead of a latency term per op.
    sync_bytes: float = 0.0
    # set for pipeline_blocks ops with layer->pipe mapped; fwd/bwd then
    # hold the closed-form GPipe makespan (used by the native engine's
    # one-task-per-op lowering) while the Python simulator replaces them
    # with the expanded per-stage schedule.
    pipeline: Optional[PipelineCost] = None

    def merge(self, other: "OpCost") -> "OpCost":
        """Fold another op's cost into one fused task (reference FusedOp:
        one launch for the group). Everything is additive — fwd/bwd_comm
        model each op's INTRINSIC collectives (e.g. a TP all-reduce),
        which fusion does not remove; what fusion avoids is resharding
        between members, and same-strategy chains never had any."""
        return OpCost(fwd=self.fwd + other.fwd, bwd=self.bwd + other.bwd,
                      fwd_comm=self.fwd_comm + other.fwd_comm,
                      bwd_comm=self.bwd_comm + other.bwd_comm,
                      sync=self.sync + other.sync, mem=self.mem + other.mem,
                      update=self.update + other.update,
                      sync_bytes=self.sync_bytes + other.sync_bytes,
                      pipeline=self.pipeline or other.pipeline)


def op_precision(op: Op) -> Tuple[str, float, float]:
    """(compute dtype name, compute itemsize, param itemsize) of the
    op's model — the precision policy the EXECUTOR will run
    (FFConfig.compute_dtype/param_dtype), so the search prices the step
    that actually executes. Weight specs are f32-declared throughout
    (builder bf16 is an ACTIVATION dtype), so scaling weight bytes by
    itemsize/4 is exact."""
    cfg = getattr(getattr(op, "model", None), "config", None)
    cd = (getattr(cfg, "compute_dtype", torch.float32)
          if cfg is not None else torch.float32)
    pd = (getattr(cfg, "param_dtype", torch.float32)
          if cfg is not None else torch.float32)
    return dtype_name(cd), float(cd.itemsize), float(pd.itemsize)


def _float_tensor_bytes(tensors, itemsize: float) -> float:
    """Bytes moved for a tensor list under a compute itemsize: float
    tensors stream at the compute dtype, integer tensors (embedding
    indices) keep their own width."""
    total = 0.0
    for t in tensors:
        if t.dtype.is_floating_point:
            total += t.num_elements * itemsize
        else:
            total += t.size_bytes()
    return total


def _axis_size(strategy: OpStrategy, mesh, logical_axis) -> int:
    ax = strategy.mesh_axis_for(logical_axis)
    if not isinstance(ax, str):
        return 1
    return mesh.shape.get(ax, 1)


def _axis_name(strategy: OpStrategy, logical_axis) -> Optional[str]:
    ax = strategy.mesh_axis_for(logical_axis)
    return ax if isinstance(ax, str) else None


def compute_shards(op: Op, strategy: OpStrategy, mesh) -> int:
    """Product of mesh-axis sizes over which this op's compute divides,
    honoring divisibility like sharding.spec_for_axes."""
    used = set()
    total = 1
    out_shape = op.outputs[0].shape if op.outputs else ()
    for i, ax in enumerate(op.output_axes()[0] if op.outputs else ()):
        name = _axis_name(strategy, ax)
        if name is None or name in used or name not in mesh.shape:
            continue
        size = mesh.shape[name]
        if i < len(out_shape) and out_shape[i] % size != 0:
            continue
        used.add(name)
        total *= size
    return max(1, total)


def op_cost(op: Op, strategy: OpStrategy, mesh,
            mm: H100MachineModel, optimizer_state_mult: float = 3.0
            ) -> OpCost:
    shards = compute_shards(op, strategy, mesh)
    flops = op.flops()
    # --- precision policy (FFConfig.compute_dtype/param_dtype): float
    # activations stream (and collectives carry) compute-dtype bytes;
    # master weights + gradients stream param-dtype bytes (the cast
    # boundary upcasts cotangents before they reach the update); MXU
    # flops price at the compute dtype's per-dtype peak. This is the
    # dominant precision lever (bf16: a higher rate, half the bytes)
    # and the whole point of making the search dtype-aware.
    cd_name, c_item, p_item = op_precision(op)
    cs = c_item / 4.0   # compute-dtype scale vs the f32-declared bytes
    ps = p_item / 4.0   # param-dtype scale
    act_bytes = _float_tensor_bytes(op.outputs, c_item)
    in_bytes = _float_tensor_bytes(op.inputs, c_item)
    w_bytes = op.weight_bytes()     # master (f32-declared) basis
    w_compute = w_bytes * cs        # the cast copies fwd/bwd stream
    is_mm = op.op_type in MATMUL_OPS
    # conv has its own MEASURED MXU fraction (measure.py
    # measure_conv_efficiency — the analog of the reference's per-shape
    # conv algorithm measurement, conv_2d.cu:173-260)
    kind = "conv" if op.op_type == "conv2d" else None

    dp = _axis_size(strategy, mesh, "sample")
    tp_axis = _axis_name(strategy, "channel_out")
    tp = _axis_size(strategy, mesh, "channel_out")
    head_tp = _axis_size(strategy, mesh, "head")
    seq_ax = _axis_name(strategy, "seq")
    sp = _axis_size(strategy, mesh, "seq")
    ep_ax = _axis_name(strategy, "expert")
    ep = _axis_size(strategy, mesh, "expert")
    pp_ax = _axis_name(strategy, "layer")
    pp = _axis_size(strategy, mesh, "layer")

    fwd_comm = 0.0
    bwd_comm = 0.0
    sync = 0.0

    # Embedding ops never stream the whole table: forward gathers only
    # the touched rows, and backward writes either the touched rows
    # (executor sparse-update path, when the indices are graph inputs)
    # or a dense table gradient (fallback). Price each accordingly —
    # w_bytes in the generic formula would overprice forward by the
    # vocab/batch ratio (10^3-10^5 for DLRM) and misrank strategies.
    # The same traffic numbers feed the device-placement branch below,
    # so placed and mesh-sharded candidates compete on equal pricing.
    sync_bytes = w_bytes * ps       # grads sync at the param dtype
    sync_data_sharded = False  # dense grads are replicated across dp
    fwd_bytes = bwd_bytes = act_bytes + in_bytes + w_compute
    if op.op_type in ("embedding", "distributed_embedding"):
        # forward gathers rows at the compute dtype; backward's row
        # gradients land at the param dtype (scatter into the master)
        n_idx = sum(t.num_elements for t in op.inputs)
        rows_bytes = c_item * op.out_dim * n_idx
        grad_rows_bytes = p_item * op.out_dim * n_idx
        cfg = op.model.config
        input_uids = {t.uid for t in op.model.input_tensors}
        # mirror the EXECUTOR's eligibility gate (executor.py
        # _sparse_table_ops) — including the optimizer's sparse_mode and
        # the lazy opt-in — so the search never prices a path the
        # executor won't take; unknown optimizer (search before
        # compile's assignment) prices dense, the conservative choice
        opt = getattr(op.model, "optimizer", None)
        mode = opt.sparse_mode() if opt is not None else None
        sparse_updates = (
            getattr(cfg, "sparse_embedding_updates", False)
            and (mode == "exact" or (
                mode == "lazy"
                and getattr(cfg, "sparse_embedding_lazy", False)))
            and all(t.uid in input_uids for t in op.inputs))
        grad_bytes = grad_rows_bytes if sparse_updates else w_bytes * ps
        fwd_bytes = act_bytes + in_bytes + rows_bytes
        bwd_bytes = act_bytes + in_bytes + grad_bytes
        sync_bytes = grad_bytes
        sync_data_sharded = sparse_updates  # each replica syncs its rows
        is_mm = False  # gather/scatter, never the MXU path
        emb_sparse_updates = sparse_updates
    else:
        emb_sparse_updates = False

    # --- device-explicit placement (reference ParallelConfig.device_ids,
    # config.h:47-73; DLRM per-table strategies dlrm_strategy.cc:1-50):
    # the op runs whole on its device set — no sample/model sharding —
    # and its output is gathered to the rest of the mesh (priced as one
    # ring all-gather); gradients flow back the same path. No DP weight
    # replica exists, so there is no gradient sync. Memory is averaged
    # over the mesh (exact when equal-size placed ops round-robin over
    # all devices, as the DLRM strategy does).
    if op.op_type == "distributed_embedding":
        # normalize to the UNPADDED (num_tables) basis: weight_specs
        # reflects num_slots once a placement was applied to the live
        # op, and pricing a new candidate from the padded bytes would
        # double-count (the placement A/B's simulate-after-compile
        # pattern hit exactly this)
        slots = max(1, getattr(op, "num_slots", 1))
        ntab = max(1, getattr(op, "num_tables", 1))
        w_bytes = w_bytes * ntab / slots
    devices = strategy.device_ids
    if devices:
        # a length-1 id is the whole-op pin shorthand the executor
        # expands to every table (ops/embedding.py apply_placement) —
        # price what will actually run
        ntab = getattr(op, "num_tables", None)
        if (op.op_type == "distributed_embedding" and ntab
                and len(devices) == 1):
            devices = tuple(devices) * ntab
        # distinct devices = real concurrency (a per-table id tuple may
        # assign several tables to one device; executed via the op's
        # slot layout)
        k = max(1, len(set(devices)))
        # slot-layout pad factor: the executable lowering pads every
        # device to the largest per-device group, so skewed assignments
        # inflate the kernel — price it so search prefers balance
        if (op.op_type == "distributed_embedding"
                and len(devices) == ntab):
            from collections import Counter
            kmax = max(Counter(devices).values())
            n_total = max(1, int(mesh.size))
            w_bytes *= n_total * kmax / len(devices)
        n = max(1, int(mesh.size))
        fwd = mm.compute_time(flops / k, fwd_bytes / k, is_mm, kind=kind,
                              dtype=cd_name)
        if op.op_type in ("embedding", "distributed_embedding"):
            bwd = mm.compute_time(flops / k, bwd_bytes / k, is_mm,
                                  kind=kind, dtype=cd_name)
        else:
            bwd = BWD_FACTOR_BY_TYPE.get(op.op_type,
                                         BWD_FLOP_FACTOR) * fwd
        if n > k:
            fwd_comm = mm.all_gather(act_bytes, n)
            bwd_comm = mm.all_gather(act_bytes, n)
        mem = (w_bytes * (ps + optimizer_state_mult) + act_bytes * 2) \
            * k / n
        # dense updates sweep the (NORMALIZED) table bytes — sync_bytes
        # was captured before the padded-slot normalization above and
        # would overprice a live placed op by slots/ntab
        upd_basis = sync_bytes if emb_sparse_updates else w_bytes * ps
        upd = (upd_basis * (2.0 + 2.0 * optimizer_state_mult) / k
               / (mm.spec.hbm_bandwidth * mm.efficiency["elementwise"])
               if w_bytes > 0 else 0.0)
        return OpCost(fwd=fwd, bwd=bwd, fwd_comm=fwd_comm,
                      bwd_comm=bwd_comm, sync=0.0, mem=mem, update=upd)

    fwd = mm.compute_time(flops / shards, fwd_bytes / shards, is_mm,
                          kind=kind, dtype=cd_name)
    if op.op_type in ("embedding", "distributed_embedding"):
        bwd = mm.compute_time(flops / shards, bwd_bytes / shards, is_mm,
                              kind=kind, dtype=cd_name)
    else:
        bwd = BWD_FACTOR_BY_TYPE.get(op.op_type, BWD_FLOP_FACTOR) * fwd

    # --- TP (Megatron pattern): fwd all-reduce of the (data-sharded)
    # output when the contraction dim is sharded; bwd all-reduce of the
    # input grad. (The reference hand-built this as replica tensors +
    # backward2 reduction, linear.cu:144-270.)
    eff_tp = max(tp, head_tp)
    if eff_tp > 1 and op.op_type in ("linear", "multihead_attention",
                                     "conv2d", "lstm"):
        fwd_comm += mm.all_reduce(act_bytes / dp, eff_tp, tp_axis)
        bwd_comm += mm.all_reduce(in_bytes / dp, eff_tp, tp_axis)

    # --- embedding vocab sharding: output psum over vocab axis
    vocab = _axis_size(strategy, mesh, "vocab")
    if vocab > 1 and op.op_type in ("embedding", "distributed_embedding"):
        fwd_comm += mm.all_reduce(act_bytes / dp, vocab,
                                  _axis_name(strategy, "vocab"))
        bwd_comm += mm.all_reduce(act_bytes / dp, vocab,
                                  _axis_name(strategy, "vocab"))

    # --- table sharding (DistributedEmbedding): vocab-complete tables
    # distributed over the axis — lookups run where the tables live,
    # outputs all-gather (the executable form of per-device placement)
    table = _axis_size(strategy, mesh, "table")
    if table > 1 and op.op_type == "distributed_embedding" \
            and op.num_tables % table != 0:
        # the executor's spec_for_axes silently drops a non-dividing
        # axis (weight stays replicated) — price it the same way
        table = 1
    if table > 1 and op.op_type == "distributed_embedding":
        fwd /= table
        bwd /= table
        fwd_comm += mm.all_gather(act_bytes / dp, table,
                                  _axis_name(strategy, "table"))
        bwd_comm += mm.all_gather(act_bytes / dp, table,
                                  _axis_name(strategy, "table"))

    # --- SP attention: priced per the lowering that actually executes
    # (parallel/ulysses.sp_mode_for — the op consults the same policy)
    if sp > 1 and op.op_type == "multihead_attention":
        from ..parallel.ulysses import sp_mode_for
        b, s_q = op.inputs[0].shape[0], op.inputs[0].shape[1]
        # key input carries the kv length in cross-attention
        s_kv = (op.inputs[1].shape[1] if len(op.inputs) > 1
                else s_q)
        mode = sp_mode_for(
            getattr(op.model.config, "sp_attention", "auto"),
            num_heads=getattr(op, "num_heads", 1), seq_size=sp,
            batch_local=max(1, b // max(1, dp)), seq_q=s_q, seq_kv=s_kv)
        if mode == "alltoall":
            # fwd: q,k,v head-scatter + out seq-scatter = 4 all-to-alls
            # of one activation shard; bwd mirrors them
            act = in_bytes / 3 / max(1, dp)
            fwd_comm += 4 * mm.all_to_all(act / sp, sp, seq_ax)
            bwd_comm += 4 * mm.all_to_all(act / sp, sp, seq_ax)
        else:
            # ring: (S-1) kv-shard hops each way
            kv_bytes = 2 * in_bytes / 3 / max(1, dp)  # k+v of the three
            fwd_comm += (sp - 1) * mm.ppermute(kv_bytes / sp, seq_ax)
            bwd_comm += 2 * (sp - 1) * mm.ppermute(kv_bytes / sp, seq_ax)

    # --- EP: dispatch + combine all-to-alls of the capacity buffers
    if ep > 1 and op.op_type == "moe_ffn":
        disp_bytes = (op.num_experts * op.capacity * op.in_dim
                      * c_item) / dp
        fwd_comm += 2 * mm.all_to_all(disp_bytes / ep, ep, ep_ax)
        bwd_comm += 2 * mm.all_to_all(disp_bytes / ep, ep, ep_ax)

    # --- PP: stages divide the layer stack, so per-device compute is
    # fwd/pp; the GPipe schedule stretches that by the bubble factor
    # (M + pp - 1)/M. fwd/bwd carry the closed-form makespan (native
    # engine's one-task-per-op view); `pipeline` carries the per-stage
    # tick costs so the Python simulator can run the real schedule.
    # optimizer-update sweep (see the `update` computation below) —
    # needed early here so pipelined ops fold it into their per-stage
    # ticks (the Python simulator prices expanded pipelines from
    # PipelineCost, never from OpCost.update)
    def update_sweep(divisor: float) -> float:
        if w_bytes <= 0:
            return 0.0
        upd_bytes = sync_bytes * (2.0 + 2.0 * optimizer_state_mult)
        per_dev = upd_bytes / max(1.0, divisor)
        if sync_data_sharded:
            per_dev /= max(1, dp)
        return per_dev / (mm.spec.hbm_bandwidth
                          * mm.efficiency["elementwise"])

    pipeline = None
    if pp > 1 and op.op_type == "pipeline_blocks":
        M = op.num_microbatches
        upd = update_sweep(eff_tp * ep * pp * vocab * table)
        fwd_stage = fwd / (pp * M)
        # each stage's weights update once per step; amortized over the
        # M bwd ticks so BOTH engines and the expanded schedule carry it
        bwd_stage = bwd / (pp * M) + upd / M
        mb_bytes = in_bytes / max(1, dp) / M
        hop = mm.ppermute(mb_bytes, pp_ax)
        pipeline = PipelineCost(stages=pp, microbatches=M,
                                fwd_stage=fwd_stage, bwd_stage=bwd_stage,
                                hop=hop)
        bubble = (M + pp - 1) / (M * pp)
        fwd *= bubble
        bwd = bwd * bubble + upd  # closed form (native engine view)
        fwd_comm += (M + pp - 1) * hop
        bwd_comm += (M + pp - 1) * hop

    # --- DP gradient sync: all-reduce of each weight's grad over the
    # data axis (the reference's NCCL all-reduce / PS update+prefetch,
    # optimizer_kernel.cu:113-180)
    payload = 0.0
    if dp > 1 and sync_bytes > 0:
        # weights sharded over model/expert/pipe/vocab/table axes reduce
        # per-device grad bytes proportionally; sparse-updated embedding
        # rows are additionally data-sharded (each replica contributes
        # only its batch shard's rows)
        payload = sync_bytes / max(1, eff_tp * ep * pp * vocab * table)
        if sync_data_sharded:
            payload /= dp
        sync = mm.all_reduce(payload, dp, _axis_name(strategy, "sample"))

    # --- memory: master weights at param_dtype + optimizer state
    # (f32 slots, counted on the declared-bytes basis) + compute-dtype
    # activations per device
    w_per_dev = w_bytes / max(1, eff_tp * ep * pp * vocab * table)
    act_per_dev = act_bytes / shards
    mem = w_per_dev * (ps + optimizer_state_mult) + act_per_dev * 2

    # --- optimizer update: the reference's update tasks carry
    # run_time=0 ("assume update takes no time", simulator.cc:420) —
    # but the elementwise sweep reads grads+weights+slots and writes
    # weights+slots, HBM-bound and significant for table-heavy models.
    # Priced beyond reference parity; sparse-updated embeddings sweep
    # only their touched rows (grad_bytes above). Serialized onto the
    # device after backward (folded into bwd so BOTH search engines
    # price it identically with no task-graph/ABI change).
    # pipelined ops already folded the sweep into their stage ticks /
    # closed-form bwd above — a nonzero field would double-count
    update = (0.0 if pipeline is not None
              else update_sweep(eff_tp * ep * pp * vocab * table))

    return OpCost(fwd=fwd, bwd=bwd, fwd_comm=fwd_comm, bwd_comm=bwd_comm,
                  sync=sync, mem=mem, update=update, sync_bytes=payload,
                  pipeline=pipeline)


def staged_pipeline_cost(model, mesh, mm: H100MachineModel,
                         stage_of: Dict[str, int], microbatches: int,
                         schedule: str = "gpipe",
                         optimizer_state_mult: float = 3.0,
                         n_dev: Optional[int] = None):
    """Price a graph-level staged strategy (core/staged.py): the whole
    model runs as one pipeline whose per-stage tick costs are the sum of
    that stage's ops at microbatch granularity; hops carry the cut
    tensors. Returns (PipelineCost, per_stage_sync, total_mem).

    Mirrors what executes: no intra-stage sharding except the data axis
    over microbatch samples; per-stage weight grads all-reduce over data
    replicas; activation stash scales with the schedule's peak
    (M for GPipe, min(S - s, M) for 1F1B — the 1F1B memory story)."""
    from ..parallel.graph_pipeline import build_stage_plan
    plan = build_stage_plan(model, stage_of)
    S = plan.num_stages
    M = max(1, int(microbatches))
    ndata = mesh.shape.get("data", 1)
    local = OpStrategy({"sample": "data"})  # data split only
    # precision policy, applied like op_cost does: compute-dtype
    # activation bytes (stash + wire), param-dtype master weights,
    # f32-basis optimizer slots, param-dtype grad sync — a staged bf16
    # candidate must not be memory-penalized on f32 bytes while the
    # non-staged strategies it competes with are priced at bf16
    _, c_item, p_item = op_precision(model.ops[0]) if model.ops \
        else ("float32", 4.0, 4.0)
    ps = p_item / 4.0
    fwd_stages, bwd_stages, syncs, mems = [], [], [], []
    for s, ops in enumerate(plan.stages):
        f = b = sync_bytes = w_bytes = act_bytes = 0.0
        for op in ops:
            c = op_cost(op, local, mesh, mm,
                        optimizer_state_mult=optimizer_state_mult)
            f += c.fwd / M
            # the update sweep runs once per STEP, not per microbatch —
            # amortize it over the M bwd ticks like the Python executor
            # applies one optimizer step per dispatch
            b += (c.bwd + c.update) / M
            w = op.weight_bytes()
            sync_bytes += w * ps
            w_bytes += w
            act_bytes += _float_tensor_bytes(op.outputs,
                                             c_item) / ndata
        fwd_stages.append(f)
        bwd_stages.append(b)
        syncs.append(mm.all_reduce(sync_bytes, ndata, "data")
                     if ndata > 1 and sync_bytes > 0 else 0.0)
        peak = M if schedule != "1f1b" else min(S - s, M)
        mems.append(w_bytes * (ps + optimizer_state_mult)
                    + act_bytes / M * max(1, peak) * 2)
    hops = []
    # the inter-stage wire carries float activations at the compute
    # dtype (graph_pipeline._wire_layouts) — price the hops the same
    for cut in plan.cuts:
        cut_bytes = _float_tensor_bytes(cut, c_item) / M / ndata
        hops.append(mm.ppermute(cut_bytes, "pipe"))
    pc = PipelineCost(
        stages=S, microbatches=M,
        fwd_stage=sum(fwd_stages) / S, bwd_stage=sum(bwd_stages) / S,
        hop=(sum(hops) / len(hops)) if hops else 0.0,
        fwd_stages=fwd_stages, bwd_stages=bwd_stages, hops=hops)
    # per-device memory: one stage per device normally; under an
    # interleaved layout (n_dev < S, passed by the caller who knows the
    # compile lowering) device d owns the round-robin stage set
    # {d, d+n_dev, ...} and holds ALL their rows
    if n_dev is None:
        n_dev = S
    if mems and S > n_dev > 0 and S % n_dev == 0:
        mem_total = max(sum(mems[d::n_dev]) for d in range(n_dev))
    else:
        mem_total = max(mems) if mems else 0.0
    return pc, syncs, mem_total


# ---------------------------------------------------------------------------
# Serve-program pricing
# ---------------------------------------------------------------------------



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
