"""Thin numpy-level wrappers over the native library's C API
(``flexflow_tpu/native/wrappers.py``'s counterparts): the event-loop
simulator of one task graph, the per-(op, candidate) ``CostTable``, the
annealing loop and the simulation of one candidate assignment, the
prefetching row gatherer (``NativePrefetchLoader``) and the host
``embedding_bag``. Each builds the library at first use
(``native.get_lib``) and raises when it cannot; ``embedding_bag``
reduces in numpy when the library is turned off, as JAX's does."""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import available, get_lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _p(a: np.ndarray):
    ct = {np.dtype(np.int32): ctypes.c_int32,
          np.dtype(np.int64): ctypes.c_int64,
          np.dtype(np.float32): ctypes.c_float,
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


class NativePrefetchLoader:
    """Background-thread batch gatherer over C-contiguous host arrays
    (``csrc/dataloader.cc``): a native thread gathers each batch's rows
    of every array into one of two contiguous buffers, so the gather of
    batch i+1 overlaps the caller's staging of batch i.

    :meth:`next_batch` returns zero-copy views into those buffers. A
    view is valid only until the next :meth:`next_batch` call (the
    worker then refills its buffer) and until :meth:`close`: copy what
    must outlive it."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 drop_last: bool = True):
        lib = get_lib()
        self._lib = lib
        self.names = list(arrays.keys())
        self.arrays = [np.ascontiguousarray(arrays[k]) for k in self.names]
        n = {len(a) for a in self.arrays}
        if len(n) != 1:
            raise ValueError("arrays must have equal sample counts")
        self.n_samples = n.pop()
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError(f"batch_size {batch_size} < 1")
        self.row_bytes = _i64([
            a.nbytes // max(1, len(a)) for a in self.arrays])
        self.row_shapes = [a.shape[1:] for a in self.arrays]
        self.dtypes = [a.dtype for a in self.arrays]
        ptrs = (ctypes.c_void_p * len(self.arrays))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in self.arrays])
        self._h = lib.ffdl_create(len(self.arrays), ptrs, _p(self.row_bytes),
                                  self.n_samples, self.batch_size,
                                  int(drop_last))
        if not self._h:
            raise RuntimeError("ffdl_create failed")

    def start_epoch(self, order: Optional[np.ndarray] = None) -> None:
        """Begin an epoch over ``order`` (a permutation of the samples;
        the identity by default), restarting the prefetch at batch 0."""
        if order is None:
            order = np.arange(self.n_samples, dtype=np.int64)
        order = _i64(order)
        if order.shape != (self.n_samples,):
            raise ValueError(f"order has shape {order.shape} for "
                             f"{self.n_samples} samples")
        if len(order) and (order.min() < 0
                           or order.max() >= self.n_samples):
            raise ValueError("order holds a row outside the arrays")
        self._lib.ffdl_start_epoch(self._h, _p(order))

    @property
    def num_batches(self) -> int:
        return int(self._lib.ffdl_num_batches(self._h))

    def next_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """The next batch as zero-copy views into the native double
        buffer (valid until the following call); None at epoch end."""
        k = len(self.arrays)
        out = (ctypes.c_void_p * k)()
        rows = ctypes.c_int32(0)
        idx = self._lib.ffdl_next_batch(self._h, out, ctypes.byref(rows))
        if idx < 0:
            return None
        batch = {}
        for i, name in enumerate(self.names):
            shape = (rows.value,) + self.row_shapes[i]
            nbytes = int(np.prod(shape)) * self.dtypes[i].itemsize
            buf = (ctypes.c_char * nbytes).from_address(out[i])
            batch[name] = np.frombuffer(buf, dtype=self.dtypes[i]).reshape(
                shape)
        return batch

    def close(self) -> None:
        """Stop the worker and free the buffers (views die with them).
        Safe to call more than once."""
        if getattr(self, "_h", None):
            self._lib.ffdl_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def embedding_bag(table: np.ndarray, indices: np.ndarray,
                  mode: str = "sum") -> np.ndarray:
    """Host-side embedding-bag: ``out[b] = reduce(table[indices[b]])``.

    table (V, D) float32; indices (B, L) int, where a negative or
    out-of-range entry is padding; ``mode`` "sum" or "mean" (over the
    bag's valid entries). The data-pipeline role of the reference's AVX2
    CPU embedding-bag (src/ops/embedding_avx2.cc): pre-reduce multi-hot
    categorical features before the batch ships to the card. Runs the
    native code when the library is on (:func:`available`), numpy when
    it is turned off."""
    table = np.ascontiguousarray(table, np.float32)
    idx = _i64(indices)
    if table.ndim != 2 or idx.ndim != 2:
        raise ValueError(f"table {table.shape} and indices {idx.shape} "
                         f"must both be 2-D")
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode {mode!r} is not 'sum' or 'mean'")
    b, bag = idx.shape
    v, d = table.shape
    if available():
        out = np.empty((b, d), np.float32)
        get_lib().ffdl_embedding_bag(
            _p(table), ctypes.c_int64(v), ctypes.c_int32(d), _p(idx),
            ctypes.c_int64(b), ctypes.c_int32(bag),
            ctypes.c_int32(0 if mode == "sum" else 1), _p(out))
        return out
    valid = (idx >= 0) & (idx < v)
    gathered = np.where(valid[..., None], table[np.clip(idx, 0, v - 1)], 0.0)
    out = gathered.sum(axis=1)
    if mode == "mean":
        out /= np.maximum(valid.sum(axis=1, keepdims=True), 1)
    return out
