"""The analytic description of the machine the cost model prices
(``flexflow_tpu/parallel/mesh.py``'s ``MachineSpec``).

The field names are the JAX package's, so one ``machine_model_file``
JSON means the same thing to both packages. The defaults are JAX's (a
TPU v5p slice); :meth:`MachineSpec.h100` describes the card the port
runs on. Meshes (``make_mesh``) come with tensor-parallel serving
(ROADMAP module item 7).
"""

from __future__ import annotations

import dataclasses

# serving-side tensor parallelism's one mesh axis (the JAX package's
# parallel/mesh.TENSOR)
TENSOR = "tensor"


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
