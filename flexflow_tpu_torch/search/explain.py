"""Explainable placement: per-op cost breakdowns, rejected
alternatives, and the HBM memory ledger; counterpart of
``flexflow_tpu/search/explain.py``, whole.

* :func:`explain_placement` — for every op under a (found or given)
  strategy: the chosen axis map, the priced cost decomposed into the
  simulator's task components (fwd / bwd / update / collectives /
  grad sync; they sum to the op's priced total bit-exactly), and the
  top-k rejected candidate axis maps with their deltas, priced by the
  same ``Simulator._op_cost`` tiers the search annealed through; plus
  the step-level view: simulated step time, the per-task-class
  breakdown the drift calibrator aligns against, and the HBM ledger.
  :func:`explain_report` renders it as text.

* :func:`pytree_device_bytes` — the resident bytes of live tensors,
  which the training and serving ledgers read
  (``FFModel.memory_ledger``, ``ServeEngine.memory_ledger``,
  ``DisaggCluster.memory_ledger``). One device holds every tensor
  whole: the port shards nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..parallel.pconfig import Strategy
from .cost_model import OpCost
from .simulator import Simulator, _axis_sig

__all__ = ["explain_placement", "explain_report",
           "op_cost_components", "pytree_device_bytes"]


def op_cost_components(c: OpCost) -> Dict[str, float]:
    """One op's priced cost split into the simulator's task components
    (seconds). The reported ``total_s`` is the sum of exactly these
    values in exactly this order, so components always sum to the
    priced cost bit-exactly."""
    return {"fwd": c.fwd, "bwd": c.bwd, "update": c.update,
            "fwd_comm": c.fwd_comm, "bwd_comm": c.bwd_comm,
            "grad_sync": c.sync}


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def pytree_device_bytes(tree) -> float:
    """Resident bytes of the live tensors in `tree` (nested dicts, lists
    and tuples; None and non-tensor leaves count nothing): what occupies
    the card's memory. One device holds every tensor whole — the port
    shards nothing yet."""
    return float(sum(x.nbytes for x in _leaves(tree)
                     if hasattr(x, "nbytes")))


def explain_placement(model, mesh=None, strategy: Optional[Strategy]
                      = None, simulator: Optional[Simulator] = None,
                      top_k: int = 3) -> dict:
    """Why the placement looks the way it does: per-op chosen config,
    cost breakdown, and the top-k rejected alternatives, plus the
    step-level totals (simulated step time, per-class breakdown, HBM
    accounting vs the machine's capacity).

    `strategy` defaults to the model's current strategy (the search
    winner after optimize); `simulator` defaults to a fresh Simulator
    on the model's machine model (``default_machine_model`` of the mesh
    description) — pass the search's own simulator to explain from its
    exact calibrated state."""
    from .mcmc import candidate_maps
    from ..parallel.pconfig import OpStrategy

    mesh = mesh if mesh is not None else model.mesh
    if mesh is None:
        from ..parallel.mesh import make_mesh
        mesh = make_mesh((1,), ("data",))
    sim = simulator or Simulator(model, mesh)
    strategy = (strategy if strategy is not None
                else (model.strategy or Strategy()))
    cfg = model.config

    ops: List[dict] = []
    for i, op in enumerate(model.ops):
        s = strategy.for_op(op.name)
        c = sim._op_cost(op, strategy)
        comps = op_cost_components(c)
        chosen_sig = _axis_sig(s)
        alts = []
        for cand in candidate_maps(op, mesh, cfg, op_index=i):
            alt = OpStrategy(dict(cand))
            sig = _axis_sig(alt)
            if sig == chosen_sig:
                continue
            ac = sim._op_cost_for(op, alt, sig)
            a_comps = op_cost_components(ac)
            a_total = sum(a_comps.values())
            alts.append({
                "axis_map": {k: str(v) for k, v in cand.items()},
                "total_s": a_total,
                "components": a_comps,
                "mem_bytes": ac.mem,
            })
        alts.sort(key=lambda a: a["total_s"])
        total = sum(comps.values())
        ops.append({
            "op": op.name,
            "op_type": op.op_type,
            "chosen": {k: str(v) for k, v in s.axis_map.items()},
            "total_s": total,
            "components": comps,
            "mem_bytes": c.mem,
            "alternatives": [
                {**a, "delta_s": a["total_s"] - total}
                for a in alts[:max(0, int(top_k))]],
            "rejected_candidates": len(alts),
        })

    mem_per_dev = sim.memory_per_device(strategy)
    hbm = float(sim.mm.spec.hbm_capacity)
    return {
        "mesh": dict(mesh.shape),
        "step_time_s": sim.simulate(strategy),
        "step_breakdown_s": sim.step_breakdown(strategy),
        "ops": ops,
        "memory": {
            "sim_bytes_per_device": mem_per_dev,
            "hbm_capacity_bytes": hbm,
            "hbm_utilization": mem_per_dev / hbm if hbm else 0.0,
            "hbm_penalty_s": sim.mm.memory_penalty(mem_per_dev),
        },
    }


def explain_report(info: dict, max_alts: int = 2) -> str:
    """Human rendering of :func:`explain_placement`: one row per op
    (chosen config, cost, dominant component) with its best rejected
    alternatives indented underneath."""
    lines = [
        f"placement on mesh {info['mesh']}: simulated step "
        f"{info['step_time_s']*1e3:.3f} ms",
        "breakdown: " + " ".join(
            f"{k}={v*1e3:.3f}ms"
            for k, v in info["step_breakdown_s"].items() if v),
    ]
    mem = info["memory"]
    lines.append(
        f"hbm: {mem['sim_bytes_per_device']/2**20:.1f} MiB/device of "
        f"{mem['hbm_capacity_bytes']/2**30:.0f} GiB "
        f"({mem['hbm_utilization']:.1%}"
        + (f", penalty {mem['hbm_penalty_s']*1e3:.3f} ms"
           if mem["hbm_penalty_s"] else "")
        + ")")
    lines.append(f"{'op':28s} {'type':18s} {'config':26s} "
                 f"{'cost ms':>9s} {'mem MiB':>8s}")
    for o in info["ops"]:
        chosen = ",".join(f"{k}->{v}" for k, v in o["chosen"].items()) \
            or "replicated"
        lines.append(
            f"{o['op']:28s} {o['op_type']:18s} {chosen:26s} "
            f"{o['total_s']*1e3:>9.4f} {o['mem_bytes']/2**20:>8.2f}")
        for a in o["alternatives"][:max_alts]:
            amap = ",".join(f"{k}->{v}"
                            for k, v in a["axis_map"].items()) \
                or "replicated"
            lines.append(
                f"{'':28s} {'rejected':18s} {amap:26s} "
                f"{a['total_s']*1e3:>9.4f} "
                f"(+{a['delta_s']*1e3:.4f} ms)")
    return "\n".join(lines)
