"""Analytic machine model of the port's device, an NVIDIA H100 SXM:
roofline compute, memory and collective costs.

The counterpart of ``flexflow_tpu/search/machine_model.py``: the same
interface and the same formulas (``TPUMachineModel``'s), over
:meth:`MachineSpec.h100`. What differs is the card's own numbers: its
datasheet figures in the spec, f32 matmuls at the CUDA cores' rate
(the port runs f32 with TF32 off), and ``efficiency`` factors measured
on the card by ``search/measure.py`` (the collective factor is still a
guess). A mesh here is a description (parallel/mesh.MeshShape, or
anything with a ``shape`` mapping of axis name to size and a ``size``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

from ..parallel.mesh import MachineSpec


@dataclasses.dataclass
class H100MachineModel:
    spec: MachineSpec = dataclasses.field(default_factory=MachineSpec.h100)
    # achieved fractions of the spec's peaks (the JAX package's keys):
    # measure.calibrate() on an NVIDIA H100 80GB HBM3 at 700 W
    # (chip_smoke.py disagg_phase), rounded; "collective" is
    # unmeasured (one card has no NVLink peer), an uncalibrated guess
    efficiency: Dict[str, float] = dataclasses.field(default_factory=lambda: {
        "matmul": 0.887,     # bf16 tensor-core GEMM, 8192^3
        "matmul:float32": 0.771,  # f32 GEMM, TF32 off, 8192^3
        "conv": 0.395,       # cuDNN bf16 channels-last convolutions
        "elementwise": 0.905,  # one f32 pass (fraction of HBM rate)
        "collective": 0.8,   # fraction of the NVLink rate (a guess)
    })
    # per-dtype matmul rate relative to spec.peak_flops (the bf16
    # tensor-core rate). The port computes f32 with TF32 off, so f32
    # matmuls run on the CUDA cores: the datasheet's 67 TFLOP/s f32
    # over 989 TFLOP/s bf16 dense
    dtype_flops_scale: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {
            "bfloat16": 1.0, "float16": 1.0, "float32": 67e12 / 989e12})
    # mesh axes that cross hosts (priced at DCN rates)
    dcn_axes: tuple = ()
    # mesh axis -> tuple of physical torus dims it spans ({} = flat)
    axis_topology: Dict[str, tuple] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def like(cls, other) -> "H100MachineModel":
        """A model holding another machine model's numbers (any object
        with ``spec``, ``efficiency``, ``dtype_flops_scale``,
        ``dcn_axes`` and ``axis_topology`` under these names, such as
        the JAX package's ``TPUMachineModel``): the same formulas on
        the same numbers price the same seconds."""
        spec = MachineSpec(**{f.name: getattr(other.spec, f.name)
                              for f in dataclasses.fields(MachineSpec)})
        return cls(spec=spec, efficiency=dict(other.efficiency),
                   dtype_flops_scale=dict(other.dtype_flops_scale),
                   dcn_axes=tuple(other.dcn_axes),
                   axis_topology=dict(other.axis_topology))

    def _phys(self, axis: Optional[str], axis_size: int):
        """(k concurrent link sets, largest physical dim) for an axis.
        DCN axes are switched, not tori — always flat."""
        dims = (self.axis_topology.get(axis)
                if axis and axis not in self.dcn_axes else None)
        if not dims:
            return 1, axis_size
        return len(dims), max(dims)

    # ---- compute ----
    def peak_flops_for(self, dtype: Optional[str] = None) -> float:
        """Peak matmul rate for a compute dtype. None keeps the raw
        spec.peak_flops (the bf16 basis)."""
        if dtype is None:
            return self.spec.peak_flops
        return self.spec.peak_flops * self.dtype_flops_scale.get(
            str(dtype), 1.0)

    def _eff(self, key: str, dtype: Optional[str]) -> float:
        """Per-family efficiency with an optional per-dtype override:
        "matmul:float32" (written by measure.calibrate's per-dtype
        pass) beats the family factor "matmul"."""
        base = self.efficiency.get(key, self.efficiency["matmul"])
        if dtype is None:
            return base
        return self.efficiency.get(f"{key}:{dtype}", base)

    def compute_time(self, flops: float, bytes_moved: float,
                     is_matmul: bool = True,
                     kind: Optional[str] = None,
                     dtype: Optional[str] = None) -> float:
        """Roofline: the larger of the matmul time and the memory time.
        `kind` selects a measured per-family efficiency ("conv"), the
        big-GEMM factor by default; `dtype` prices at that dtype's peak
        rate and, when calibrated, its measured efficiency (callers
        scale `bytes_moved` by the dtype's itemsize themselves)."""
        eff = self._eff(kind if kind is not None else "matmul", dtype)
        t_flops = flops / (self.peak_flops_for(dtype) * eff)
        t_mem = bytes_moved / (self.spec.hbm_bandwidth
                               * self.efficiency["elementwise"])
        return max(t_flops, t_mem)

    # ---- collectives (ring formulas over the relevant axis) ----
    def _bw_lat(self, axis: Optional[str]):
        if axis is not None and axis in self.dcn_axes:
            # every chip of a host funnels its cross-host traffic
            # through one NIC
            sharers = max(1, self.spec.chips_per_host)
            return (self.spec.dcn_bandwidth / sharers,
                    self.spec.dcn_latency)
        return (self.spec.ici_bandwidth * self.efficiency["collective"],
                self.spec.ici_latency)

    def _ring_bw_mult(self, axis: Optional[str], k: int) -> float:
        """Bandwidth multiplier of ring collectives: k concurrent link
        sets on a torus; a line (no wraparound) halves it."""
        if axis is not None and axis in self.dcn_axes:
            return 1.0
        wrap = 1.0 if self.spec.ici_wraparound else 0.5
        return k * wrap

    def all_reduce(self, nbytes: float, axis_size: int,
                   axis: Optional[str] = None) -> float:
        if axis_size <= 1:
            return 0.0
        bw, lat = self._bw_lat(axis)
        k, dmax = self._phys(axis, axis_size)
        mult = self._ring_bw_mult(axis, k)
        return 2.0 * (axis_size - 1) / axis_size * nbytes / (bw * mult) \
            + 2 * (dmax - 1) * lat

    def all_gather(self, nbytes_out: float, axis_size: int,
                   axis: Optional[str] = None) -> float:
        if axis_size <= 1:
            return 0.0
        bw, lat = self._bw_lat(axis)
        k, dmax = self._phys(axis, axis_size)
        mult = self._ring_bw_mult(axis, k)
        return (axis_size - 1) / axis_size * nbytes_out / (bw * mult) \
            + (dmax - 1) * lat

    reduce_scatter = all_gather  # same ring cost

    def all_to_all(self, nbytes_local: float, axis_size: int,
                   axis: Optional[str] = None) -> float:
        if axis_size <= 1:
            return 0.0
        bw, lat = self._bw_lat(axis)
        k, dmax = self._phys(axis, axis_size)
        # bisection-bound: the cut perpendicular to the largest dim
        # carries V_local * dmax / (4 * wrap * bw); a line halves it
        wrap = 2.0 if self.spec.ici_wraparound else 1.0
        if axis is not None and axis in self.dcn_axes:
            # switched: the NIC serializes the (n-1)/n exchange
            return (axis_size - 1) / axis_size * nbytes_local / bw \
                + (axis_size - 1) * lat
        hops = dmax / 2 if self.spec.ici_wraparound else dmax
        return nbytes_local * dmax / (4.0 * wrap * bw) + hops * lat

    def ppermute(self, nbytes: float, axis: Optional[str] = None) -> float:
        bw, lat = self._bw_lat(axis)
        return nbytes / bw + lat

    # ---- host link (page handoff, host tier) ----
    def host_transfer(self, nbytes: float) -> float:
        """Seconds to move ``nbytes`` between host memory and the card:
        bytes over the link rate plus the per-transfer latency — the
        price of a disaggregated page handoff and of a host-tier
        reload."""
        if nbytes <= 0:
            return 0.0
        bw = max(1.0, float(getattr(self.spec, "host_link_bandwidth",
                                    5e10)))
        lat = float(getattr(self.spec, "host_link_latency", 5e-6))
        return nbytes / bw + lat

    # ---- memory penalty: 1 ms per MB over the device's capacity ----
    def memory_penalty(self, bytes_per_device: float) -> float:
        over = bytes_per_device - self.spec.hbm_capacity
        if over <= 0:
            return 0.0
        return over * 1e-9

    # ---- calibration I/O ----
    def save_calibration(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.efficiency, f)

    def load_calibration(self, path: str) -> None:
        with open(path) as f:
            self.efficiency.update(json.load(f))


def assign_axis_topology(mesh, torus_dims: tuple,
                         dcn_axes: tuple = ()) -> Dict[str, tuple]:
    """Lay mesh axes out over the physical torus factorization in mesh
    axis order: each axis consumes whole torus dims while their product
    divides its size; an axis that cannot be covered exactly falls back
    to one ring. Cross-host axes consume no torus dims."""
    out: Dict[str, tuple] = {}
    if mesh is None or not torus_dims:
        return out
    remaining = list(torus_dims)
    for name, size in mesh.shape.items():
        if name in dcn_axes:
            continue
        got: list = []
        prod = 1
        while remaining and prod < size and size % (
                prod * remaining[0]) == 0:
            prod *= remaining[0]
            got.append(remaining.pop(0))
        if prod == size and got:
            out[name] = tuple(got)
        else:
            remaining = got + remaining
    return out


def _process_layout():
    """(process count, devices per process) of the running job:
    torch.distributed's world when it is initialized, else one
    process."""
    try:
        import torch
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return (int(dist.get_world_size()),
                    max(1, int(torch.cuda.device_count())))
    except Exception:
        pass
    return 1, 1


def default_machine_model(mesh=None, spec: Optional[MachineSpec] = None,
                          machine_file: Optional[str] = None
                          ) -> H100MachineModel:
    """The model of the card the port runs on (:meth:`MachineSpec.h100`
    unless a spec is given). `machine_file` (FFConfig
    .machine_model_file) overrides MachineSpec fields from JSON, as in
    the JAX package, and may pin mesh axes onto torus dims
    (``"axis_topology"``). In a multi-process job the mesh's `data`
    axis crosses hosts and is priced at DCN rates."""
    user_spec = spec is not None
    if spec is None:
        spec = MachineSpec.h100()
    file_keys = set()
    file_data: Dict = {}
    if machine_file:
        with open(machine_file) as f:
            file_data = json.load(f)
        for k, v in file_data.items():
            if hasattr(spec, k):
                setattr(spec, k, v)
                file_keys.add(k)
    dcn_axes = ()
    if mesh is not None:
        spec.num_chips = int(mesh.size)
        procs, local = _process_layout()
        if procs > 1 and "data" in mesh.shape:
            dcn_axes = ("data",)
            if "chips_per_host" not in file_keys and not user_spec:
                spec.chips_per_host = local
    # machine-file pins govern the axes they mention (a pin that does
    # not factor its axis is dropped and that axis stays flat); the
    # other axes derive from the torus dims the pins left
    pins: Dict[str, tuple] = {}
    pinned_axes: tuple = ()
    if "axis_topology" in file_data:
        raw = {k: tuple(v) for k, v in file_data["axis_topology"].items()}
        pinned_axes = tuple(raw)
        import math
        import warnings
        for name, dims in raw.items():
            size = mesh.shape.get(name) if mesh is not None else None
            if size is not None and math.prod(dims) != size:
                warnings.warn(
                    f"machine file axis_topology[{name!r}]={dims} "
                    f"does not factor the mesh axis size {size}; "
                    f"ignoring the pin (flat-ring pricing)")
            else:
                pins[name] = dims
    pool = list(getattr(spec, "ici_torus_dims", ()) or ())
    for dims in pins.values():
        for d in dims:
            if d in pool:
                pool.remove(d)
    derived = assign_axis_topology(mesh, tuple(pool),
                                   dcn_axes + pinned_axes)
    return H100MachineModel(spec=spec, dcn_axes=dcn_axes,
                            axis_topology={**derived, **pins})
