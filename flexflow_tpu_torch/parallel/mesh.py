"""Mesh descriptions and the analytic machine description the cost
model prices (``flexflow_tpu/parallel/mesh.py``).

A mesh is first a *description*: :class:`MeshShape` holds the ordered
axis sizes, the axis names and an array of device indices, the fields
of a ``jax.sharding.Mesh`` the search reads. The strategy search prices
strategies on it for a machine of any size, with no process group.

A mesh *executes* once it is bound (:meth:`MeshShape.bind`) to a
``torch.distributed`` process group of exactly ``size`` ranks, one
process a rank (:func:`init_distributed`): device index ``i`` of the
description is rank ``i``, each rank gets its coordinate on every axis
and one subgroup per axis (the ranks that differ only in that axis's
coordinate, a row or column of the device grid). The backend is NCCL
when every rank has a card of its own and gloo on the CPU; ranks that
share one card must ask for gloo (NCCL refuses two ranks on one device)
and their collectives stage through host memory
(parallel/collectives.py). :func:`default_mesh` puts every rank on
``data``.

``MachineSpec``'s field names are the JAX package's, so one
``machine_model_file`` JSON means the same thing to both packages. The
defaults are JAX's (a TPU v5p slice); :meth:`MachineSpec.h100`
describes the card the port runs on.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

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

    def bind(self) -> "BoundMesh":
        """This mesh on the running process group: the rank's
        coordinates and one subgroup per axis. Every rank calls it (the
        subgroups are made collectively, in the same order everywhere);
        the result is cached, so binding the same description again
        makes no new groups. Raises when no group of exactly ``size``
        ranks is running."""
        import torch.distributed as dist
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                f"a mesh of {self.size} devices ({self.shape}) executes "
                f"on a torch.distributed process group of {self.size} "
                f"ranks: call parallel.mesh.init_distributed() first "
                f"(one process a rank)")
        world = dist.get_world_size()
        if world != self.size:
            raise RuntimeError(
                f"mesh {self.shape} has {self.size} devices but the "
                f"process group has {world} ranks")
        key = (self.axis_names, tuple(self.shape.values()),
               tuple(int(d) for d in self.devices.reshape(-1)), _GEN[0])
        bound = _BOUND.get(key)
        if bound is None:
            bound = _BOUND[key] = BoundMesh(self)
        return bound


# bound meshes by (axes, shape, devices, process-group generation)
_BOUND: Dict[tuple, "BoundMesh"] = {}
_GEN = [0]
# the running group's facts (init_distributed)
_DIST: Dict[str, object] = {}


class BoundMesh:
    """A mesh description bound to the running process group: ``rank``,
    ``world``, ``backend``, the rank's ``coords`` (axis -> coordinate),
    ``groups`` (axis -> the subgroup along that axis, in coordinate
    order) and ``group_ranks`` (axis -> the global ranks of that
    subgroup). ``host_groups`` (axis -> a gloo group of the same
    ranks) carries small host-side exchanges (the serving lockstep
    guard) without a device round trip: the axis group itself under
    gloo, a gloo twin of it under NCCL. ``staging`` says whether the
    collectives stage CUDA tensors through host memory (gloo on a
    card)."""

    def __init__(self, mesh: MeshShape):
        import torch.distributed as dist
        self.mesh = mesh
        self.shape = mesh.shape
        self.axis_names = mesh.axis_names
        self.size = mesh.size
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = str(dist.get_backend())
        where = np.argwhere(mesh.devices == self.rank)
        if len(where) != 1:
            raise RuntimeError(
                f"rank {self.rank} appears {len(where)} times in the "
                f"mesh's device grid {mesh.devices.tolist()}")
        coord = tuple(int(c) for c in where[0])
        self.coords = dict(zip(mesh.axis_names, coord))
        self.groups = {}
        self.host_groups = {}
        self.group_ranks = {}
        self._subgroups = {}
        grid = mesh.devices
        for ax_i, ax in enumerate(mesh.axis_names):
            # every line of the grid along this axis, in a fixed order:
            # new_group is collective over the whole world
            moved = np.moveaxis(grid, ax_i, -1).reshape(
                -1, grid.shape[ax_i])
            for line in moved:
                ranks = [int(r) for r in line]
                g = dist.new_group(ranks) if self.world > 1 else \
                    dist.group.WORLD
                h = dist.new_group(ranks, backend="gloo") \
                    if self.world > 1 and self.backend != "gloo" else g
                if self.rank in ranks:
                    self.groups[ax] = g
                    self.host_groups[ax] = h
                    self.group_ranks[ax] = ranks

    def axis_size(self, axis) -> int:
        """The size of ``axis``, or of a tuple of axes (their
        product)."""
        if isinstance(axis, tuple):
            return int(np.prod([self.axis_size(a) for a in axis],
                               dtype=np.int64))
        return int(self.shape.get(axis, 1))

    def coord(self, axis) -> int:
        """The rank's coordinate on ``axis``; on a tuple of axes its
        row-major index over them (the first axis major), the block a
        spec entry naming those axes gives this rank."""
        if isinstance(axis, tuple):
            c = 0
            for a in axis:
                c = c * self.axis_size(a) + self.coord(a)
            return c
        return int(self.coords.get(axis, 0))

    def subgroup(self, axes: tuple):
        """The group of the ranks that differ from this one only in
        their coordinates on ``axes`` (several mesh axes taken as one),
        its members in the row-major order of :meth:`coord` over
        ``axes`` *as given* (the first axis major): a spec entry
        ``("model", "data")`` on a ``("data", "model")`` mesh lists its
        members model-major, so member j holds block j of the entry
        (the process group itself numbers them by global rank: the
        collectives map between the two, parallel/collectives.py). Axes
        the mesh lacks are dropped. Made on first use and cached by the
        entry: every rank must ask for the same entries in the same
        order (``new_group`` is collective over the world), which a
        program every rank runs alike does."""
        axes = tuple(a for a in axes if a in self.shape)
        if not axes:
            return None
        if len(axes) == 1:
            return self.groups[axes[0]], self.group_ranks[axes[0]]
        hit = self._subgroups.get(axes)
        if hit is not None:
            return hit
        import torch.distributed as dist
        grid = self.mesh.devices
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(grid.ndim) if i not in idx]
        moved = np.transpose(grid, rest + idx).reshape(
            -1, int(np.prod([grid.shape[i] for i in idx])))
        mine = None
        for line in moved:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks) if self.world > 1 else \
                dist.group.WORLD
            if self.rank in ranks:
                mine = (g, ranks)
        self._subgroups[axes] = mine
        return mine

    @property
    def staging(self) -> bool:
        return self.backend == "gloo" and _DIST.get("device_type") == "cuda"

    def __repr__(self):
        return (f"BoundMesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, backend={self.backend})")


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     device: Optional[str] = None) -> dict:
    """Join (or start) the process group this process's rank trains in.

    Rank, world size and the local rank come from the arguments, else
    from torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; the
    rendezvous is ``init_method`` (tests pass a ``file://`` path), else
    ``env://`` over ``MASTER_ADDR`` / ``MASTER_PORT``. ``device`` is
    the device the rank's models live on: the card (card
    ``LOCAL_RANK`` modulo the cards present) unless the caller passes
    ``device="cpu"``; a rank asked for the card that finds none
    raises. The backend is ``gloo`` on the CPU and ``nccl`` on the card
    when every local rank has a card of its own; ranks that share a
    card must pass ``backend="gloo"`` (NCCL refuses two ranks on one
    device with its own error, "Duplicate GPU detected"). Returns the
    group's facts (backend, rank, world, local_rank, device). A second
    call returns them without a new group."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dict(_DIST)
    env = os.environ
    rank = int(rank if rank is not None else env.get("RANK", 0))
    world = int(world_size if world_size is not None
                else env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError(
                "init_distributed needs an init_method (file://... or "
                "tcp://host:port) or torchrun's MASTER_ADDR/MASTER_PORT")
        init_method = "env://"
    cuda = torch.cuda.is_available()
    ncards = torch.cuda.device_count() if cuda else 0
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not cuda:
        raise RuntimeError(
            "init_distributed: the rank's device is the card but CUDA is "
            "not available (pass device='cpu' to run ranks on the CPU)")
    if backend is None:
        if dev.type == "cpu":
            backend = "gloo"
        elif ncards >= local_world:
            backend = "nccl"
        else:
            raise ValueError(
                f"{local_world} local ranks share {ncards} card(s): NCCL "
                f"takes one rank a card, so pass backend='gloo' to run "
                f"ranks that share a card")
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % ncards)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", local_rank % ncards)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
    _GEN[0] += 1
    _DIST.clear()
    _DIST.update(backend=backend, rank=rank, world=world,
                 local_rank=local_rank, device=str(dev),
                 device_type=dev.type)
    return dict(_DIST)


def shutdown_distributed() -> None:
    """Leave the process group (and forget the meshes bound on it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _BOUND.clear()
    _DIST.clear()


def default_mesh() -> MeshShape:
    """Every rank of the running group on ``data`` (one device without
    a group)."""
    import torch.distributed as dist
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    return make_mesh((n,), (DATA,))


def bound_mesh(mesh) -> Optional[BoundMesh]:
    """The executing form of ``mesh`` for a model: None for no mesh, or
    for a one-device mesh unless a group of exactly one rank runs (the
    meshless path: a one-device model inside a rank of a larger group
    is that rank's own), else :meth:`MeshShape.bind` (which raises when
    a mesh of several devices has no group of its size)."""
    if mesh is None:
        return None
    import torch.distributed as dist
    running = dist.is_available() and dist.is_initialized()
    if int(mesh.size) == 1 and not (running
                                    and dist.get_world_size() == 1):
        return None
    return mesh.bind()


def serve_tensor_mesh(tensor_parallel: int,
                      devices: Optional[Sequence] = None) -> MeshShape:
    """The 1-D serving mesh ServeEngine shards the mixed step over:
    ``tensor_parallel`` devices on the ``tensor`` axis (head-parallel
    attention and head-sharded KV pages, a vocab-sharded embedding and
    head). It executes bound to a process group of exactly that many
    ranks (:meth:`MeshShape.bind`), one engine a rank; every engine of a
    process (the replicas of a pool, the roles of a cluster) binds the
    same description and so shares the one ``tensor`` group."""
    return make_mesh((int(tensor_parallel),), (TENSOR,), devices)


def serve_devices() -> int:
    """The devices a serving placement search prices over: the running
    process group's world size, else the visible cards (at least 1).
    One engine spans at most the group (its tensor degree must equal
    the world size to execute)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return max(1, torch.cuda.device_count())


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
