"""The serve half of ``flexflow_tpu/search/simulator.py``: the ONE
mixed serving step's task graph (cost_model.serve_step_tasks) run to its
critical path, its per-class breakdown (the drift attribution vector)
and its Perfetto export. The training ``Simulator`` comes with the
training search's port (ROADMAP module item 5).

Every memory-over-capacity step pays the machine model's penalty (1 ms
per MB), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from . import machine_model as _machine
from .machine_model import H100MachineModel


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
