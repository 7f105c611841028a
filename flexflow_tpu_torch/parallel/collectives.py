"""The collectives of an executing mesh, over one mesh axis at a time.

The JAX package never calls a collective: GSPMD inserts them from the
shardings it is given. The port has no GSPMD for its own kernels, so
each op's local rule (and the executor around it) calls the ones GSPMD
would have inserted, from this module — the only one that knows the
backend. Each takes a :class:`parallel.mesh.BoundMesh` and an axis
name; an axis the mesh lacks is size 1 and the call is the identity
with no launch.

Differentiable forms (``torch.autograd.Function``), each the adjoint
pair of the one-device semantics they stand for:

``all_reduce``      sum of the ranks' partial values; backward: identity
                    (the sum feeds computation replicated over the axis,
                    whose gradient every rank already holds in full)
``copy_to``         identity; backward: all-reduce (a value replicated
                    over the axis feeds computation sharded over it, so
                    each rank holds part of its gradient)
``psum``            ``copy_to(all_reduce(x))``: a sum whose result feeds
                    sharded computation (BatchNorm's batch statistics)
``all_gather(dim)`` shards concatenated along ``dim``; backward: the
                    rank's slice of the (full) gradient
``gather_sum(dim)`` the same gather feeding sharded computation;
                    backward: reduce-scatter
``split(dim)``      the rank's slice of a replicated value; backward:
                    all-gather
``reduce_scatter(dim)`` the slice of the sum; backward: all-gather
``all_to_all(split, concat)`` JAX's tiled ``lax.all_to_all`` (the
                    Ulysses re-partition, parallel/ulysses.py); backward:
                    the inverse all-to-all
``ppermute(shift)`` JAX's ``lax.ppermute`` one block along the axis (the
                    ring's K/V hop, parallel/ring_attention.py); backward:
                    the reverse shift

The stage-to-stage pairs of a pipeline (parallel/graph_pipeline.py,
parallel/pipeline.py) are not differentiable forms: the schedules move
activations forward with :func:`send_next` / :func:`recv_prev` and
cotangents back with :func:`send_prev` / :func:`recv_next`, along the
``pipe`` axis as a ring (the peers are the global ranks of the axis's
group, coordinate ``c + 1`` and ``c - 1`` modulo its size). Each makes
a :class:`P2P` and :func:`post` posts all of a rank's transfers of one
schedule step together in one ``batch_isend_irecv`` and waits for them,
so no schedule can deadlock (under gloo a lone blocking ``send`` whose
peer is itself sending would hang both ranks). Each transfer counts once
in ``launches`` (``"send"``, ``"recv"``); under NCCL they run as they
are (their completion ordered before the current stream's later work),
under gloo with CUDA tensors they stage through pinned host memory like
every other collective; a failed transfer raises from its wait.

An axis may also be a tuple of mesh axes, a spec entry that splits a
dimension over their product: the group of the ranks that differ only
on them (``BoundMesh.subgroup``), its members in the entry's own
row-major order (the first axis major, the order of
``BoundMesh.coord``), so a gather, an all-to-all or a ring hop over
it moves block j to or from member j. A sum does not care for the
order: the gradient sync of a data x seq mesh sums over both.

Under NCCL the tensors go to NCCL as they are (on the current stream,
so a CUDA-graph capture records them and a replay runs them; an
all-reduce on a second stream forked from the capture stream replays
right on an H100, tools/torch_mesh_probe.py). Under gloo with CUDA
tensors — ranks that share a card — every collective stages
explicitly: the tensor is copied to a pinned host buffer, the
collective runs on the host copy and the result is copied back; the
bytes are counted in ``staged_bytes`` and a gloo step cannot be
captured (the copies synchronize with the host), so such steps run
with ``capture=False``. gloo itself refuses none of the collectives
used here on CUDA tensors (all_reduce, all_gather_into_tensor,
reduce_scatter_tensor, broadcast and list all_gather each gave the
right values on an H100 with the card's torch: tools/torch_mesh_probe.py)
— it copies through the host inside the call; the explicit staging
makes those copies visible, counted and the same for every
collective. Staging is never used under NCCL or on the CPU. Every
launch counts once in ``launches`` (through
``kernels/_launches.count_launch``, so a launch recorded in a capture
counts at each replay); a failed collective raises.

Tensor-parallel serving runs under ``no_grad`` and calls the plain
forms: :func:`all_reduce_` in place after each row-parallel projection
and :func:`gather_tensor` on dim 1 for the logits. Its ranks each run a
whole engine (scheduler, page tables, sampling) and must take the same
host decisions step by step; :class:`Lockstep` checks that they do and
carries the one decision that reads a clock (see its docstring).
"""

from __future__ import annotations

import hashlib
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..kernels._launches import count_launch

# collective launches by kind (one a call that reaches the backend)
launches = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
            "all_to_all": 0, "ppermute": 0, "barrier": 0, "lockstep": 0,
            "send": 0, "recv": 0}
# bytes copied between the card and pinned host memory by gloo staging
staged_bytes = {"to_host": 0, "to_device": 0}


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0
    for k in staged_bytes:
        staged_bytes[k] = 0


def _entry(bm, axis):
    """``axis`` as the mesh knows it: a name, or a tuple of the names
    the mesh has in the entry's own order (one name: that name)."""
    if not isinstance(axis, tuple):
        return axis
    axes = tuple(a for a in axis if a in bm.shape)
    return axes[0] if len(axes) == 1 else axes


def _group(bm, axis):
    """(process group, size) of ``axis``, or (None, 1) when the mesh
    has no such axis. A tuple of axes names the group of the ranks that
    differ only on those axes (``BoundMesh.subgroup``): its members in
    the row-major order of the axes *as the entry orders them*, the
    order of ``BoundMesh.coord`` over the same tuple, so a gather over
    it concatenates the entry's blocks in block order."""
    if bm is None:
        return None, 1
    axis = _entry(bm, axis)
    if axis == ():
        return None, 1
    if isinstance(axis, tuple):
        return bm.subgroup(axis)[0], bm.axis_size(axis)
    if axis not in bm.groups:
        return None, 1
    return bm.groups[axis], bm.axis_size(axis)


def _ranks(bm, axis) -> List[int]:
    """The global ranks of ``axis``'s group, in coordinate order."""
    axis = _entry(bm, axis)
    if isinstance(axis, tuple):
        return bm.subgroup(axis)[1]
    return bm.group_ranks[axis]


def _coord(bm, axis) -> int:
    return bm.coord(_entry(bm, axis))


def _pos(bm, axis):
    """The process group's position of each member of ``axis``'s
    group, member j (block j of the entry) first, or None where they
    agree. ``torch.distributed`` orders a group's ranks by their global
    rank, whatever order ``new_group`` was given them in; an entry whose
    axes are not in the mesh's order (``("model", "data")`` on a
    ``("data", "model")`` mesh) numbers its blocks otherwise, so every
    collective whose result depends on the order maps through this."""
    ranks = _ranks(bm, axis)
    order = sorted(ranks)
    if order == ranks:
        return None
    return [order.index(r) for r in ranks]


def _to_blocks(t: torch.Tensor, pos) -> torch.Tensor:
    """The (n, ...) chunks of ``t`` in group order put in block order."""
    return t if pos is None else t[pos]


def _to_group(t: torch.Tensor, pos) -> torch.Tensor:
    """The (n, ...) chunks of ``t`` in block order put in group order."""
    if pos is None:
        return t
    inv = [0] * len(pos)
    for j, p in enumerate(pos):
        inv[p] = j
    return t[inv]


def _stages(bm, t: torch.Tensor) -> bool:
    return bm.backend == "gloo" and t.device.type == "cuda"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)                         # synchronous: gloo reads it next
    staged_bytes["to_host"] += t.numel() * t.element_size()
    return h


def _to_device(dst: torch.Tensor, h: torch.Tensor) -> None:
    dst.copy_(h)
    staged_bytes["to_device"] += h.numel() * h.element_size()


class Pending:
    """An all-reduce in flight (``all_reduce_(async_op=True)``):
    :meth:`wait` completes it, staged results copied back."""

    __slots__ = ("work", "host", "dst")

    def __init__(self, work, host=None, dst=None):
        self.work, self.host, self.dst = work, host, dst

    def wait(self) -> None:
        if self.work is not None:
            self.work.wait()
            self.work = None
        if self.host is not None:
            _to_device(self.dst, self.host)
            self.host = None


def all_reduce_(t: torch.Tensor, bm, axis: str, async_op: bool = False):
    """Sum ``t`` over ``axis`` in place. With ``async_op`` returns a
    :class:`Pending` (the gradient buckets), else None."""
    import torch.distributed as dist
    g, n = _group(bm, axis)
    if g is None:
        return Pending(None) if async_op else None
    count_launch(launches, "all_reduce")
    if _stages(bm, t):
        h = _to_host(t)
        work = dist.all_reduce(h, group=g, async_op=async_op)
        if async_op:
            return Pending(work, h, t)
        _to_device(t, h)
        return None
    work = dist.all_reduce(t, group=g, async_op=async_op)
    return Pending(work) if async_op else None


def gather_tensor(t: torch.Tensor, bm, axis: str, dim: int = 0
                  ) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated on ``dim`` in
    coordinate order (not differentiable), contiguous: a weight gathered
    on its last dimension is laid out as the whole weight is (a strided
    view would send cuBLAS down another operand order and round the
    product otherwise)."""
    import torch.distributed as dist
    g, n = _group(bm, axis)
    if g is None:
        return t
    count_launch(launches, "all_gather")
    src = t.movedim(dim, 0).contiguous()
    staged = _stages(bm, src)
    if staged:
        src = _to_host(src)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=g)
    if staged:
        host = out
        out = torch.empty(host.shape, dtype=host.dtype, device=t.device)
        _to_device(out, host)
    pos = _pos(bm, axis)
    if pos is not None:
        out = _to_blocks(out.reshape((n,) + tuple(src.shape)), pos
                         ).reshape(out.shape)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_tensor(t: torch.Tensor, bm, axis: str, dim: int = 0
                          ) -> torch.Tensor:
    """The rank's slice along ``dim`` of the sum of the ranks' ``t``
    over ``axis`` (not differentiable)."""
    import torch.distributed as dist
    g, n = _group(bm, axis)
    if g is None:
        return t
    count_launch(launches, "reduce_scatter")
    src = t.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide over {n} ranks")
    pos = _pos(bm, axis)
    if pos is not None:
        src = _to_group(src.reshape((n, -1) + tuple(src.shape[1:])), pos
                        ).reshape(src.shape)
    staged = _stages(bm, src)
    if staged:
        src = _to_host(src)
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=g)
    if staged:
        host = out
        out = torch.empty(host.shape, dtype=host.dtype, device=t.device)
        _to_device(out, host)
    return out.movedim(0, dim).contiguous()


def local_slice(t: torch.Tensor, bm, axis: str, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of a replicated ``t`` along
    ``dim`` over ``axis`` (no communication)."""
    g, n = _group(bm, axis)
    if g is None or n == 1:
        return t
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks of {axis!r}")
    part = size // n
    return t.narrow(dim, _coord(bm, axis) * part, part).contiguous()


def all_to_all_tensor(t: torch.Tensor, bm, axis, split_dim: int,
                      concat_dim: int) -> torch.Tensor:
    """JAX's ``lax.all_to_all(t, axis, split_dim, concat_dim,
    tiled=True)`` (not differentiable): ``t`` cut into n blocks along
    ``split_dim``, block j sent to coordinate j, and the blocks received
    concatenated along ``concat_dim`` in coordinate order. One
    ``all_to_all_single`` over a buffer of the n blocks stacked."""
    import torch.distributed as dist
    g, n = _group(bm, axis)
    if g is None:
        return t
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of "
                         f"{tuple(t.shape)} does not split over {n} ranks")
    count_launch(launches, "all_to_all")
    pos = _pos(bm, axis)
    src = _to_group(torch.stack(t.chunk(n, dim=split_dim)), pos
                    ).contiguous()
    staged = _stages(bm, src)
    if staged:
        src = _to_host(src)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=g)
    if staged:
        host = out
        out = torch.empty(host.shape, dtype=host.dtype, device=t.device)
        _to_device(out, host)
    return torch.cat(_to_blocks(out, pos).unbind(0), dim=concat_dim)


def ppermute_tensor(t: torch.Tensor, bm, axis, shift: int = 1
                    ) -> torch.Tensor:
    """JAX's ``lax.ppermute`` by ``shift`` along ``axis`` (not
    differentiable): this rank's ``t`` goes to coordinate ``(c + shift)
    mod n`` and the block of coordinate ``(c - shift) mod n`` comes
    back. The send and the receive are one ``batch_isend_irecv``, so a
    ring of any size cannot deadlock; the peers are global ranks (from
    the group's members). A shift by a multiple of the axis size (an
    axis of one rank) is the identity, with no launch."""
    import torch.distributed as dist
    g, n = _group(bm, axis)
    if g is None or n == 1 or shift % n == 0:
        return t
    count_launch(launches, "ppermute")
    ranks, c = _ranks(bm, axis), _coord(bm, axis)
    dst, src = ranks[(c + shift) % n], ranks[(c - shift) % n]
    send = t.contiguous()
    staged = _stages(bm, send)
    if staged:
        send = _to_host(send)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group=g),
           dist.P2POp(dist.irecv, recv, src, group=g)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        host = recv
        recv = torch.empty(host.shape, dtype=host.dtype, device=t.device)
        _to_device(recv, host)
    return recv


class P2P:
    """One point-to-point transfer of a schedule step: ``kind`` "send"
    or "recv", the tensor (sent, or received into in place) and the
    peer's global rank on the axis's group. Made by :func:`send_next`
    and its siblings, posted by :func:`post`."""

    __slots__ = ("kind", "tensor", "peer", "group", "host")

    def __init__(self, kind, tensor, peer, group):
        self.kind, self.tensor, self.peer, self.group = (kind, tensor,
                                                         peer, group)
        self.host = None


def _peer(bm, axis, shift: int) -> tuple:
    g, n = _group(bm, axis)
    if g is None or n == 1:
        raise ValueError(f"a pipeline transfer needs a {axis!r} axis of "
                         f"more than one rank (mesh {bm})")
    ranks, c = _ranks(bm, axis), _coord(bm, axis)
    return ranks[(c + shift) % n], g


def send_next(t: torch.Tensor, bm, axis: str = "pipe") -> P2P:
    """Send ``t`` to coordinate ``c + 1`` of ``axis`` (an activation to
    the next stage)."""
    peer, g = _peer(bm, axis, 1)
    return P2P("send", t.contiguous(), peer, g)


def recv_prev(buf: torch.Tensor, bm, axis: str = "pipe") -> P2P:
    """Receive into ``buf`` from coordinate ``c - 1`` (the previous
    stage's activation)."""
    peer, g = _peer(bm, axis, -1)
    return P2P("recv", buf, peer, g)


def send_prev(t: torch.Tensor, bm, axis: str = "pipe") -> P2P:
    """Send ``t`` to coordinate ``c - 1`` (a cotangent to the previous
    stage)."""
    peer, g = _peer(bm, axis, -1)
    return P2P("send", t.contiguous(), peer, g)


def recv_next(buf: torch.Tensor, bm, axis: str = "pipe") -> P2P:
    """Receive into ``buf`` from coordinate ``c + 1`` (the next stage's
    cotangent)."""
    peer, g = _peer(bm, axis, 1)
    return P2P("recv", buf, peer, g)


def post(bm, ops: Sequence[P2P]) -> None:
    """Post one schedule step's transfers together (one
    ``batch_isend_irecv``) and wait for all of them; received tensors
    are filled in place. Under gloo with CUDA tensors each transfer
    stages through pinned host memory (counted in ``staged_bytes``)."""
    import torch.distributed as dist
    if not ops:
        return
    staged = bm.backend == "gloo"
    posted = []
    for op in ops:
        count_launch(launches, op.kind)
        t = op.tensor
        if staged and t.device.type == "cuda":
            if op.kind == "send":
                op.host = _to_host(t)
            else:
                op.host = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
        buf = op.host if op.host is not None else t
        fn = dist.isend if op.kind == "send" else dist.irecv
        posted.append(dist.P2POp(fn, buf, op.peer, group=op.group))
    for w in dist.batch_isend_irecv(posted):
        w.wait()
    for op in ops:
        if op.kind == "recv" and op.host is not None:
            _to_device(op.tensor, op.host)
        op.host = None


def broadcast_from(t: torch.Tensor, bm, axis: str, src: int
                   ) -> torch.Tensor:
    """JAX's ``psum(where(coord == src, t, 0), axis)``: coordinate
    ``src``'s ``t`` on every rank of ``axis`` (an all-reduce in which
    the other ranks contribute zeros; not differentiable). Returns a
    new tensor; ``t`` is left as it is."""
    g, n = _group(bm, axis)
    if g is None:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format) \
        if _coord(bm, axis) == src else torch.zeros_like(
            t, memory_format=torch.contiguous_format)
    all_reduce_(out, bm, axis)
    return out


def gather_objects(obj, bm, axis: str) -> List:
    """Python objects of every rank of ``axis``, in coordinate order."""
    import torch.distributed as dist
    g, n = _group(bm, axis)
    if g is None:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=g)
    pos = _pos(bm, axis)
    return out if pos is None else [out[p] for p in pos]


class LockstepError(RuntimeError):
    """The ranks of a tensor group disagree on host state they must
    share; raised on every rank of the group at the same check."""


def digest(*parts) -> int:
    """A 63-bit digest of byte buffers (numpy arrays, bytes or str)."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        if isinstance(p, np.ndarray):
            p = np.ascontiguousarray(p).view(np.uint8)
        elif isinstance(p, str):
            p = p.encode()
        h.update(memoryview(p))
    return int.from_bytes(h.digest(), "little") >> 1


class Lockstep:
    """The lockstep guard of the ranks of one ``axis`` group that each
    run the same host program (a tensor-parallel serving engine a rank:
    every rank schedules, pages and samples for itself, and only the
    device step is sharded).

    :meth:`check` runs before each sharded step: the ranks all-gather
    the digest and byte count of what they are about to feed it (the
    packed lane buffer) and each compares every rank's row with its
    own, so a rank that diverged raises :class:`LockstepError` on every
    rank before the step runs — neither a hang in a later collective
    nor tokens computed from mixed inputs. Cost: one all-gather of two
    int64 words a rank (16 bytes; gloo, host memory).

    :meth:`exchange` runs at each step boundary, before the scheduler
    plans: every rank sends a digest of its live requests and a list of
    items (its cancel marks; rank 0 also the requests its clock found
    past their deadlines). A digest that differs raises as above; the
    items come back as every rank's list, in coordinate order, so that
    the clock is read on rank 0 only and every rank applies the same
    aborts. Cost: one all-gather of two int64 words a rank, and only
    when some rank has items, an object all-gather of them (a pickled
    list of small ints a rank; torch runs it as two all-gathers).

    So a step costs 2 all-gathers of 16 bytes a rank, and one object
    all-gather more when an abort is pending. The words travel in host
    memory on every backend, over the axis's gloo group
    (``BoundMesh.host_groups``: a gloo twin of the NCCL group under
    NCCL), so the guard never copies to or from the card and never
    waits for it: a captured step's replay is not held up by a device
    sync. The host does wait for the other ranks' words, so a step
    starts no earlier than the slowest rank's packing. Each call counts
    once in ``launches["lockstep"]``. Nothing here reads a clock, and
    retries and stall counts are functions of the step sequence (the
    fault injector fires by count), so honest ranks agree."""

    def __init__(self, bm, axis: str):
        self.bm, self.axis = bm, axis
        _, self.size = _group(bm, axis)
        self.group = bm.host_groups.get(axis) if bm is not None else None
        self.checks = 0

    def _words(self, words: Sequence[int]) -> np.ndarray:
        import torch.distributed as dist
        count_launch(launches, "lockstep")
        t = torch.tensor([int(w) for w in words], dtype=torch.int64)
        out = torch.empty((self.size * t.numel(),), dtype=t.dtype)
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out.numpy().reshape(self.size, -1)

    def _compare(self, what: str, rows: np.ndarray) -> None:
        mine = rows[self.bm.coord(self.axis)]
        off = [r for r in range(self.size) if not np.array_equal(
            rows[r], mine)]
        if off:
            raise LockstepError(
                f"lockstep guard ({what}, check {self.checks}): rank "
                f"{self.bm.rank} (coordinate {self.bm.coord(self.axis)} "
                f"of {self.axis!r}) and coordinates {off} differ "
                f"({rows.tolist()}); the ranks of a tensor-parallel "
                f"engine must be given the same requests in the same "
                f"order")

    def check(self, what: str, *buffers) -> None:
        """Raise on every rank unless every rank's ``buffers`` hold the
        same bytes."""
        if self.group is None:
            return
        self.checks += 1
        nbytes = sum(np.asarray(b).nbytes for b in buffers)
        self._compare(what, self._words((digest(*buffers), nbytes)))

    def exchange(self, what: str, state: int,
                 items: Optional[List[Any]]) -> List[List[Any]]:
        """Every rank's ``items`` (a picklable list), after checking
        that every rank's ``state`` digest is the same."""
        if self.group is None:
            return [list(items or [])]
        import torch.distributed as dist
        self.checks += 1
        items = list(items or [])
        rows = self._words((state, len(items)))
        self._compare(what, rows[:, :1])
        if not rows[:, 1].any():
            return [[] for _ in range(self.size)]
        count_launch(launches, "lockstep")
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, items, group=self.group)
        return out


def barrier(bm=None) -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        count_launch(launches, "barrier")
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


# ------------------------------------------------ differentiable forms
class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bm, axis):
        y = x.clone(memory_format=torch.contiguous_format)
        all_reduce_(y, bm, axis)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bm, axis):
        ctx.bm, ctx.axis = bm, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # NCCL takes contiguous tensors only (a gradient may arrive as a
        # strided view)
        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce_(g, ctx.bm, ctx.axis)
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bm, axis, dim):
        ctx.bm, ctx.axis, ctx.dim = bm, axis, dim
        return gather_tensor(x, bm, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.bm, ctx.axis, ctx.dim), None, None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bm, axis, dim):
        ctx.bm, ctx.axis, ctx.dim = bm, axis, dim
        return gather_tensor(x, bm, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_tensor(g, ctx.bm, ctx.axis, ctx.dim),
                None, None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bm, axis, dim):
        ctx.bm, ctx.axis, ctx.dim = bm, axis, dim
        return local_slice(x, bm, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_tensor(g, ctx.bm, ctx.axis, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bm, axis, dim):
        ctx.bm, ctx.axis, ctx.dim = bm, axis, dim
        return reduce_scatter_tensor(x, bm, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_tensor(g, ctx.bm, ctx.axis, ctx.dim), None, None, None


def _trivial(bm, axis) -> bool:
    return _group(bm, axis)[0] is None


def all_reduce(x, bm, axis: str):
    return x if _trivial(bm, axis) else _AllReduce.apply(x, bm, axis)


def copy_to(x, bm, axis: str):
    return x if _trivial(bm, axis) else _CopyTo.apply(x, bm, axis)


def psum(x, bm, axis: str):
    return copy_to(all_reduce(x, bm, axis), bm, axis)


def all_gather(x, bm, axis: str, dim: int):
    return x if _trivial(bm, axis) else _AllGather.apply(x, bm, axis, dim)


def gather_sum(x, bm, axis: str, dim: int):
    return x if _trivial(bm, axis) else _GatherSum.apply(x, bm, axis, dim)


def split(x, bm, axis: str, dim: int):
    return x if _trivial(bm, axis) else _Split.apply(x, bm, axis, dim)


def reduce_scatter(x, bm, axis: str, dim: int):
    return (x if _trivial(bm, axis)
            else _ReduceScatter.apply(x, bm, axis, dim))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bm, axis, split_dim, concat_dim):
        ctx.bm, ctx.axis = bm, axis
        ctx.dims = (split_dim, concat_dim)
        return all_to_all_tensor(x, bm, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (all_to_all_tensor(g.contiguous(), ctx.bm, ctx.axis,
                                  concat_dim, split_dim),
                None, None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bm, axis, shift):
        ctx.bm, ctx.axis, ctx.shift = bm, axis, shift
        return ppermute_tensor(x, bm, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return (ppermute_tensor(g.contiguous(), ctx.bm, ctx.axis,
                                -ctx.shift), None, None, None)


def all_to_all(x, bm, axis, split_dim: int, concat_dim: int):
    """Differentiable :func:`all_to_all_tensor`; its backward is the
    inverse all-to-all (``split_dim`` and ``concat_dim`` swapped)."""
    return (x if _trivial(bm, axis) else
            _AllToAll.apply(x, bm, axis, split_dim, concat_dim))


def ppermute(x, bm, axis, shift: int = 1):
    """Differentiable :func:`ppermute_tensor`; its backward shifts the
    gradient the other way (``-shift``)."""
    return x if _trivial(bm, axis) else _PPermute.apply(x, bm, axis, shift)
