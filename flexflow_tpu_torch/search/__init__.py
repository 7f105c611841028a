"""The search and cost stack of the port (``flexflow_tpu/search`` is
the reference): the H100 machine model and its calibration on the card
(``measure``), the cost model (``op_cost`` and the serve step), the
strategy ``Simulator`` and the serve-step simulation, the MCMC
strategy search in both engines (``mcmc``, ``native_search``), op
measurement on the card (``op_measure``), the placement explainer
(``explain``), the persistent cost cache and the serve placement
searches."""

from .cost_model import (SERVE_AXIS, OpCost, PipelineCost, ServeArch,
                         ServeTask, compute_shards, kv_handoff_bytes,
                         op_cost, op_precision, serve_device_bytes,
                         serve_step_tasks, staged_pipeline_cost)
from .explain import explain_placement, explain_report, op_cost_components
from .machine_model import H100MachineModel, default_machine_model
from .mcmc import (candidate_maps, enumerate_mesh_shapes, optimize,
                   optimize_with_mesh)
from .serve_place import (DisaggPlacement, MeshTraffic, ServeMeshPlacement,
                          ServePlacement, optimize_serve,
                          optimize_serve_disagg, optimize_serve_mesh)
from .simulator import (SimTask, Simulator, TaskGraph, op_edges,
                        serve_step_breakdown, simulate_serve_step,
                        simulate_serve_tasks)

__all__ = ["H100MachineModel", "default_machine_model", "SERVE_AXIS",
           "OpCost", "PipelineCost", "ServeArch", "ServeTask",
           "compute_shards", "kv_handoff_bytes", "op_cost", "op_precision",
           "serve_device_bytes", "serve_step_tasks", "staged_pipeline_cost",
           "explain_placement", "explain_report", "op_cost_components",
           "candidate_maps", "enumerate_mesh_shapes", "optimize",
           "optimize_with_mesh", "DisaggPlacement",
           "MeshTraffic", "ServeMeshPlacement", "ServePlacement",
           "optimize_serve", "optimize_serve_disagg", "optimize_serve_mesh",
           "SimTask", "Simulator", "TaskGraph", "op_edges",
           "serve_step_breakdown", "simulate_serve_step",
           "simulate_serve_tasks"]
