"""Thin numpy-level wrappers over the native search engine's C API
(``flexflow_tpu/native/wrappers.py``'s search part): the event-loop
simulator of one task graph, the per-(op, candidate) ``CostTable``, the
annealing loop and the simulation of one candidate assignment. Each
builds the library at first use (``native.get_lib``) and raises when it
cannot."""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import get_lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _p(a: np.ndarray):
    ct = {np.dtype(np.int32): ctypes.c_int32,
          np.dtype(np.float64): ctypes.c_double}[a.dtype]
    return a.ctypes.data_as(ctypes.POINTER(ct))


def simulate_taskgraph(durations: Sequence[float], resources: Sequence[int],
                       dep_indptr: Sequence[int],
                       dep_indices: Sequence[int]) -> float:
    """Native event-loop makespan; raises if the library cannot be
    built."""
    lib = get_lib()
    d = _f64(durations)
    r = _i32(resources)
    ip = _i32(dep_indptr)
    ix = _i32(dep_indices) if len(dep_indices) else np.zeros(1, np.int32)
    out = lib.ffsim_simulate(len(d), _p(d), _p(r), _p(ip), _p(ix))
    assert out >= 0, "cycle in task graph"
    return out


class CostTable:
    """Flattened per-(op, candidate) cost arrays for the native search.

    Beyond the scalar costs, a candidate may carry an explicit device
    placement (OpStrategy.device_ids — CSR place/place_ids) and/or
    PipelineCost fields for GPipe event-loop expansion; `finalize()`
    freezes the ragged placement lists into the CSR arrays the C API
    takes. `n_devices` is the mesh device count (device resources)."""

    def __init__(self, n_cands: Sequence[int], n_devices: int = 1):
        self.n_cands = _i32(n_cands)
        self.offsets = _i32(np.concatenate([[0], np.cumsum(n_cands)]))
        self.n_devices = int(n_devices)
        total = int(self.offsets[-1])
        self.fwd = np.zeros(total)
        self.bwd = np.zeros(total)
        self.fwd_comm = np.zeros(total)
        self.bwd_comm = np.zeros(total)
        self.sync = np.zeros(total)
        self.mem = np.zeros(total)
        self._place: List[List[int]] = [[] for _ in range(total)]
        self.pipe_stages = np.zeros(total, np.int32)
        self.pipe_mb = np.zeros(total, np.int32)
        self.pipe_fwd_stage = np.zeros(total)
        self.pipe_bwd_stage = np.zeros(total)
        self.pipe_hop = np.zeros(total)
        self.place_off: Optional[np.ndarray] = None
        self.place_ids: Optional[np.ndarray] = None

    def set(self, op: int, cand: int, cost,
            devices: Optional[Sequence[int]] = None) -> None:
        i = int(self.offsets[op]) + cand
        self.fwd[i] = cost.fwd
        # the native task graph has no separate update task: fold the
        # optimizer-update sweep into bwd, exactly as the Python
        # simulator serializes it onto the device after backward
        self.bwd[i] = cost.bwd + getattr(cost, "update", 0.0)
        self.fwd_comm[i] = cost.fwd_comm
        self.bwd_comm[i] = cost.bwd_comm
        self.sync[i] = cost.sync
        self.mem[i] = cost.mem
        if devices:
            self._place[i] = [int(d) for d in devices]
        pc = getattr(cost, "pipeline", None)
        if pc is not None:
            self.pipe_stages[i] = pc.stages
            self.pipe_mb[i] = pc.microbatches
            self.pipe_fwd_stage[i] = pc.fwd_stage
            self.pipe_bwd_stage[i] = pc.bwd_stage
            self.pipe_hop[i] = pc.hop
        self.place_off = None  # invalidate frozen CSR

    def finalize(self) -> None:
        if self.place_off is not None:
            return
        self.place_off = _i32(np.concatenate(
            [[0], np.cumsum([len(p) for p in self._place])]))
        flat = [d for p in self._place for d in p]
        self.place_ids = _i32(flat) if flat else np.zeros(1, np.int32)


def mcmc_search(table: CostTable,
                edges: Sequence[Tuple[int, int]],
                prop_match: Optional[List[List[int]]],
                budget: int, alpha: float, seed: int,
                enable_propagation: bool, overlap_backward_sync: bool,
                hbm_capacity: float, time_scale: float,
                init_cand: Sequence[int],
                step_overhead: float = 0.0) -> Tuple[np.ndarray, float]:
    """Run the native annealing loop; returns (best candidate per op,
    best simulated step seconds)."""
    lib = get_lib()
    table.finalize()
    n_ops = len(table.n_cands)
    e_src = _i32([e[0] for e in edges])
    e_dst = _i32([e[1] for e in edges])
    if prop_match is None:
        prop_match = [[-1] * int(table.n_cands[s]) for s, _ in edges]
    prop_off = _i32(np.concatenate(
        [[0], np.cumsum([len(m) for m in prop_match])])) if edges else \
        np.zeros(1, np.int32)
    prop_flat = _i32([v for m in prop_match for v in m]) if edges else \
        np.zeros(1, np.int32)
    if len(e_src) == 0:
        e_src = np.zeros(1, np.int32)
        e_dst = np.zeros(1, np.int32)
    init = _i32(init_cand)
    best = np.zeros(n_ops, np.int32)
    cost = lib.ffsearch_mcmc(
        n_ops, _p(table.n_cands), _p(table.offsets),
        _p(table.fwd), _p(table.bwd), _p(table.fwd_comm),
        _p(table.bwd_comm), _p(table.sync), _p(table.mem),
        _p(table.place_off), _p(table.place_ids),
        _p(table.pipe_stages), _p(table.pipe_mb),
        _p(table.pipe_fwd_stage), _p(table.pipe_bwd_stage),
        _p(table.pipe_hop), table.n_devices,
        len(edges), _p(e_src), _p(e_dst), _p(prop_off), _p(prop_flat),
        budget, alpha, seed, int(enable_propagation),
        int(overlap_backward_sync), hbm_capacity, time_scale,
        step_overhead, _p(init), _p(best))
    return best, float(cost)


def simulate_assignment(table: CostTable, edges: Sequence[Tuple[int, int]],
                        assignment: Sequence[int],
                        overlap_backward_sync: bool, hbm_capacity: float,
                        time_scale: float,
                        step_overhead: float = 0.0) -> float:
    lib = get_lib()
    table.finalize()
    n_ops = len(table.n_cands)
    e_src = _i32([e[0] for e in edges]) if edges else np.zeros(1, np.int32)
    e_dst = _i32([e[1] for e in edges]) if edges else np.zeros(1, np.int32)
    a = _i32(assignment)
    return float(lib.ffsearch_simulate_assignment(
        n_ops, _p(table.offsets),
        _p(table.fwd), _p(table.bwd), _p(table.fwd_comm),
        _p(table.bwd_comm), _p(table.sync), _p(table.mem),
        _p(table.place_off), _p(table.place_ids),
        _p(table.pipe_stages), _p(table.pipe_mb),
        _p(table.pipe_fwd_stage), _p(table.pipe_bwd_stage),
        _p(table.pipe_hop), table.n_devices,
        len(edges), _p(e_src), _p(e_dst),
        int(overlap_backward_sync), hbm_capacity, time_scale,
        step_overhead, _p(a)))
