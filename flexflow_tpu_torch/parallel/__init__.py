"""Parallel layout of the port: only the machine description yet
(``mesh.MachineSpec``); meshes come with tensor-parallel serving
(ROADMAP module item 7)."""

from .mesh import TENSOR, MachineSpec

__all__ = ["MachineSpec", "TENSOR"]
