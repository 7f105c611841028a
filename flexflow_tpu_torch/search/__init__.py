"""The search and cost stack of the port (``flexflow_tpu/search`` is
the reference). Only the host-link price of ``machine_model`` exists
yet."""

from .machine_model import H100MachineModel, default_machine_model

__all__ = ["H100MachineModel", "default_machine_model"]
