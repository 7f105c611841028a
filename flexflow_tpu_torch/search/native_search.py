"""Native-backed MCMC strategy search; counterpart of
``flexflow_tpu/search/native_search.py``, whole.

Lowers the model graph + per-op candidate strategies into flat arrays
and runs the annealing loop in C++ (csrc/mcmc.cc) — the native hot loop
the reference keeps in FFModel::optimize + Simulator::simulate_runtime
(model.cc:1905-1968, simulator.cc:330-629).  Candidate costs still come
from the Python cost model (cost_model.op_cost), computed once per
(op, candidate) up front; only the search walk itself is native. The
engine is the port's own build of the sources
(flexflow_tpu_torch/native): a failed build raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import threading

from ..parallel.pconfig import OpStrategy, Strategy
from .simulator import Simulator, _axis_sig, op_edges

# the C++ engine predates the threaded mesh-shape sweep; serialize
# entry rather than audit csrc/mcmc.cc for hidden global state (the
# native walk is fast — Python-side annealing still overlaps it)
_NATIVE_LOCK = threading.Lock()


def _map_key(m: Dict[str, object]):
    return tuple(sorted((k, str(v)) for k, v in m.items()))


def lower_to_arrays(model, sim: Simulator, cands: Dict[str, list],
                    init_strategy: Strategy):
    """Build (CostTable, edges, prop_match, init assignment, cand lists).

    Edge order matches the Python simulator's iteration over op.inputs
    so backward-dependency construction is identical in both engines."""
    from ..native.wrappers import CostTable

    ops = model.ops
    op_index = {op.name: i for i, op in enumerate(ops)}

    cand_lists: List[List[dict]] = []
    for op in ops:
        lst = [dict(m) for m in cands[op.name]]
        init_map = dict(init_strategy.for_op(op.name).axis_map)
        if _map_key(init_map) not in {_map_key(m) for m in lst}:
            lst.append(init_map)  # searchable back to candidates either way
        cand_lists.append(lst)

    init_assign = []
    for i, op in enumerate(ops):
        init_map = _map_key(dict(init_strategy.for_op(op.name).axis_map))
        idx = next(j for j, m in enumerate(cand_lists[i])
                   if _map_key(m) == init_map)
        init_assign.append(idx)

    table = CostTable([len(l) for l in cand_lists],
                      n_devices=int(sim.mesh.size))
    for i, op in enumerate(ops):
        for j, m in enumerate(cand_lists[i]):
            s = OpStrategy(dict(m))
            # priced through the simulator's 3-tier cost cache (memory
            # -> persistent disk store -> compute, with measured
            # grounding applied at compute) — both engines rank on the
            # same numbers, and the native table, the biggest per-search
            # cost consumer (ops x candidates), populates and reuses
            # the fingerprint-keyed persistent store too
            c = sim._op_cost_for(op, s, _axis_sig(s))
            table.set(i, j, c, devices=s.device_ids)

    _, op_pairs = op_edges(model)
    edges: List[Tuple[int, int]] = [
        (op_index[src.name], op_index[dst.name]) for src, dst in op_pairs]

    prop_match = []
    for src, dst in edges:
        keys_dst = {_map_key(m): j for j, m in enumerate(cand_lists[dst])}
        prop_match.append([keys_dst.get(_map_key(m), -1)
                           for m in cand_lists[src]])

    return table, edges, prop_match, init_assign, cand_lists


def optimize_native(model, sim: Simulator, cands: Dict[str, list],
                    budget: int, alpha: float, seed: int,
                    verbose: bool = False) -> Optional[Strategy]:
    """Run the search natively; None when FLEXFLOW_TORCH_NO_NATIVE
    turns the engine off. A failed build raises."""
    from .. import native
    if not native.available():
        return None
    from ..native.wrappers import mcmc_search

    cfg = model.config
    init = (model.strategy or Strategy()).copy()
    with _NATIVE_LOCK:
        table, edges, prop_match, init_assign, cand_lists = \
            lower_to_arrays(model, sim, cands, init)
        best_idx, best_cost = mcmc_search(
            table, edges, prop_match, budget, alpha, seed,
            enable_propagation=bool(cfg.enable_propagation),
            overlap_backward_sync=sim.overlap,
            hbm_capacity=sim.mm.spec.hbm_capacity,
            time_scale=sim.time_scale,
            init_cand=init_assign,
            step_overhead=sim.step_overhead)

    best = init.copy()
    for i, op in enumerate(model.ops):
        best.set(op.name, OpStrategy(dict(cand_lists[i][int(best_idx[i])])))
    if verbose:
        print(f"[search/native] best estimated step time: "
              f"{best_cost*1e3:.3f} ms")
    return best
