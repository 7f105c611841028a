"""The search and cost stack of the port (``flexflow_tpu/search`` is
the reference): the H100 machine model and its calibration on the card,
the serve half of the cost model and simulator, the persistent cost
cache and the serve placement searches. The training search (op costs,
the ``Simulator``, MCMC) comes with ROADMAP module item 5."""

from .cost_model import (SERVE_AXIS, ServeArch, ServeTask,
                         kv_handoff_bytes, serve_device_bytes,
                         serve_step_tasks)
from .machine_model import H100MachineModel, default_machine_model
from .serve_place import (DisaggPlacement, MeshTraffic, ServeMeshPlacement,
                          ServePlacement, optimize_serve,
                          optimize_serve_disagg, optimize_serve_mesh)
from .simulator import (serve_step_breakdown, simulate_serve_step,
                        simulate_serve_tasks)

__all__ = ["H100MachineModel", "default_machine_model", "SERVE_AXIS",
           "ServeArch", "ServeTask", "kv_handoff_bytes",
           "serve_device_bytes", "serve_step_tasks", "DisaggPlacement",
           "MeshTraffic", "ServeMeshPlacement", "ServePlacement",
           "optimize_serve", "optimize_serve_disagg", "optimize_serve_mesh",
           "serve_step_breakdown", "simulate_serve_step",
           "simulate_serve_tasks"]
