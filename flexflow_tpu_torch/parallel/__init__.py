"""Parallel layout of the port: mesh descriptions and the machine
description (``mesh``), per-op strategies (``pconfig``), strategy files
(``strategy_io``) and the planners the simulator reads
(``graph_pipeline``, ``ulysses``). Nothing here executes a mesh: the
port trains on one device (ROADMAP module item 2)."""

from .mesh import (ALL_AXES, DATA, EXPERT_AX, MODEL, PIPE, SEQ_AX, TENSOR,
                   MachineSpec, MeshShape, make_mesh, single_device_mesh)
from .pconfig import (DEVICE_KEY, OpStrategy, ParallelConfig, Strategy,
                      megatron_strategy, placement_assignment,
                      sequence_parallel_strategy)

__all__ = ["ALL_AXES", "DATA", "EXPERT_AX", "MODEL", "PIPE", "SEQ_AX",
           "TENSOR", "MachineSpec", "MeshShape", "make_mesh",
           "single_device_mesh", "DEVICE_KEY", "OpStrategy",
           "ParallelConfig", "Strategy", "megatron_strategy",
           "placement_assignment", "sequence_parallel_strategy"]
