"""Analytic machine model of the port's device, an NVIDIA H100 SXM.

The counterpart of ``flexflow_tpu/search/machine_model.py``, which
prices a TPU. Only what the serving tier reads exists yet:
:meth:`H100MachineModel.host_transfer`, the price of moving bytes over
the card's host link, which the host tier weighs against recomputing a
prefix (``ServeEngine._host_reload``). Compute, memory and collective
costs come with the port of the search stack.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class H100MachineModel:
    """The H100's host link. Uncalibrated: the rate is the PCIe Gen5
    x16 spec-sheet figure for one direction (32 GT/s x 16 lanes with
    128b/130b coding, 63.0 GB/s), not a measurement; the per-transfer
    latency is unmeasured and priced at 0 until a calibration sets
    it."""

    host_link_bandwidth: float = 32e9 * 16 / 8 * 128 / 130
    host_link_latency: float = 0.0

    def host_transfer(self, nbytes: float) -> float:
        """Seconds to move ``nbytes`` between host memory and the card:
        bytes over the link rate plus the per-transfer latency (JAX's
        formula, the H100's link)."""
        if nbytes <= 0:
            return 0.0
        bw = max(1.0, float(self.host_link_bandwidth))
        return nbytes / bw + float(self.host_link_latency)


def default_machine_model() -> H100MachineModel:
    """The model of the card the port serves on."""
    return H100MachineModel()
