"""Mesh descriptions and the analytic machine description the cost
model prices (``flexflow_tpu/parallel/mesh.py``).

A mesh here is a *description*: :class:`MeshShape` holds the ordered
axis sizes, the axis names and an array of device indices, the fields
of a ``jax.sharding.Mesh`` the search reads. The strategy search prices
strategies on it for a machine of any size; the port executes on one
device, and the process groups that would run a mesh of several cards
wait for ROADMAP module item 2 (``FFModel(mesh=)`` with more than one
device raises until then).

``MachineSpec``'s field names are the JAX package's, so one
``machine_model_file`` JSON means the same thing to both packages. The
defaults are JAX's (a TPU v5p slice); :meth:`MachineSpec.h100`
describes the card the port runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# canonical axis names (the JAX package's): data parallelism, tensor
# parallelism, sequence parallelism, expert parallelism, pipeline stages
DATA = "data"
MODEL = "model"
SEQ_AX = "seq"
EXPERT_AX = "expert"
PIPE = "pipe"
# serving-side tensor parallelism's one mesh axis (the JAX package's
# parallel/mesh.TENSOR)
TENSOR = "tensor"

ALL_AXES = (DATA, MODEL, SEQ_AX, EXPERT_AX, PIPE)


class MeshShape:
    """A mesh description: ``shape`` (axis name -> size, in axis
    order), ``axis_names``, ``size`` (the device count) and
    ``devices`` (a numpy array of device indices of that shape) — what
    ``jax.sharding.Mesh`` offers the cost model and the search."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 devices=None):
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(
                f"mesh shape {shape} and axes {axes} differ in length")
        if len(set(axes)) != len(axes):
            raise ValueError(f"mesh axis names repeat: {axes}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axis sizes must be >= 1: {shape}")
        n = int(np.prod(shape, dtype=np.int64))
        devices = np.asarray(np.arange(n) if devices is None
                             else devices).reshape(-1)[:n]
        if devices.size != n:
            raise ValueError(
                f"mesh needs {n} devices, have {devices.size}")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.devices = devices.reshape(shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"MeshShape({self.shape})"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> MeshShape:
    """A mesh description of axis sizes and names over device indices
    0..n-1 (or the first n of ``devices``). It describes a machine, so
    it may be larger than the cards present."""
    return MeshShape(shape, axes, devices)


def single_device_mesh() -> MeshShape:
    return make_mesh((1,), (DATA,))


@dataclasses.dataclass
class MachineSpec:
    """Analytic description of the target machine for the cost model.

    Defaults are the JAX package's (a TPU v5p chip): a spec built with
    no arguments prices the same machine in both packages. :meth:`h100`
    is the port's device, and what ``default_machine_model`` builds."""

    num_chips: int = 1
    # per-chip
    peak_flops: float = 459e12  # bf16 FLOP/s
    hbm_bandwidth: float = 2.765e12  # bytes/s
    hbm_capacity: float = 95e9  # bytes
    vmem_capacity: float = 128e6
    # interconnect: bytes/s per link and per-hop latency
    ici_bandwidth: float = 9e10 * 2
    ici_latency: float = 1e-6
    dcn_bandwidth: float = 25e9
    dcn_latency: float = 10e-6
    # chips sharing one host NIC (cross-host collectives funnel through
    # it: per-chip DCN bandwidth is dcn_bandwidth / chips_per_host)
    chips_per_host: int = 4
    # host link between a chip's memory and its host's DRAM: the path a
    # disaggregated deployment ships finished KV pages over and the
    # host tier spills to (TPUMachineModel / H100MachineModel
    # .host_transfer)
    host_link_bandwidth: float = 5e10
    host_link_latency: float = 5e-6
    # physical torus factorization of the slice, () = flat/unknown
    # (every mesh axis priced as one ring)
    ici_torus_dims: tuple = ()
    # wraparound links present (torus vs line)
    ici_wraparound: bool = True

    @staticmethod
    def h100(num_chips: int = 1) -> "MachineSpec":
        """An NVIDIA H100 SXM5 from NVIDIA's datasheet. Every figure is
        a datasheet figure, uncalibrated: ``search/measure.py`` measures
        the fractions of them the card reaches (the machine model's
        ``efficiency``), not the figures themselves."""
        return MachineSpec(
            num_chips=num_chips,
            # datasheet: dense bf16 tensor-core rate (1979 TFLOP/s is
            # the 2:4-sparse figure)
            peak_flops=989e12,
            # datasheet: HBM3 bandwidth and capacity
            hbm_bandwidth=3.35e12,
            hbm_capacity=80e9,
            # no software-managed on-chip memory is priced (the TPU's
            # VMEM field); 228 KiB of shared memory per SM x 132 SMs
            vmem_capacity=132 * 228 * 1024,
            # datasheet: NVLink 4, 900 GB/s per card both ways, 450e9
            # a direction; the per-hop latency is unmeasured (priced
            # at the JAX default until a calibration sets it)
            ici_bandwidth=450e9,
            ici_latency=1e-6,
            # NVSwitch is switched, not a torus: every axis one ring
            ici_torus_dims=(),
            # the host link: PCIe Gen5 x16, one direction (32 GT/s x
            # 16 lanes with 128b/130b coding, 63.0 GB/s); its
            # per-transfer latency is unmeasured and priced at 0
            host_link_bandwidth=32e9 * 16 / 8 * 128 / 130,
            host_link_latency=0.0,
            # one card per host in the machines the port runs on
            chips_per_host=1)
