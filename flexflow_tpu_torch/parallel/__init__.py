"""Parallel layout of the port: mesh descriptions, the machine
description and the executing mesh's process groups (``mesh``), per-op
strategies (``pconfig``), layouts and resharding (``sharding``), the
collectives (``collectives``), local rank processes (``launch``),
strategy files (``strategy_io``), pipelines (``graph_pipeline``: stage
plans, schedules and their execution; ``pipeline``: stacked blocks) and
``ulysses``. Data parallelism; linear, attention and embedding tensor
parallelism; sequence parallelism (``ring_attention``,
``ulysses.alltoall_attention``); expert parallelism and placed
embedding tables execute (core/executor.py), pipelines too
(core/staged.py, ops/pipeline.py), and so does tensor-parallel serving
(serve/engine.py)."""

from .mesh import (ALL_AXES, DATA, EXPERT_AX, MODEL, PIPE, SEQ_AX, TENSOR,
                   BoundMesh, MachineSpec, MeshShape, default_mesh,
                   init_distributed, make_mesh, serve_tensor_mesh,
                   single_device_mesh)
from .pconfig import (DEVICE_KEY, OpStrategy, ParallelConfig, Strategy,
                      megatron_strategy, placement_assignment,
                      sequence_parallel_strategy)

__all__ = ["ALL_AXES", "DATA", "EXPERT_AX", "MODEL", "PIPE", "SEQ_AX",
           "TENSOR", "BoundMesh", "MachineSpec", "MeshShape",
           "default_mesh", "init_distributed", "make_mesh",
           "serve_tensor_mesh", "single_device_mesh", "DEVICE_KEY", "OpStrategy",
           "ParallelConfig", "Strategy", "megatron_strategy",
           "placement_assignment", "sequence_parallel_strategy"]
