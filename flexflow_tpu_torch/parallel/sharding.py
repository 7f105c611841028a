"""Resolve (op, strategy, mesh) into layouts, and move tensors between
them; counterpart of ``flexflow_tpu/parallel/sharding.py``.

A layout is a *spec*: a tuple with one entry a tensor dimension, each
entry None (the dimension whole on every rank), a mesh axis name (the
dimension split over that axis, coordinate c holding block c) or a
tuple of axis names (split over their product, the first axis major) —
the entries of JAX's ``PartitionSpec``, trailing Nones trimmed, so a
spec here equals ``tuple(P(...))`` of the JAX package for the same op,
strategy and mesh. :func:`spec_for_axes`, :func:`op_output_sharding`,
:func:`weight_sharding`, :func:`effective_op_strategy` and
:func:`batch_sharding` are JAX's rules.

JAX hands a sharding to ``device_put`` or ``with_sharding_constraint``
and GSPMD moves the data. Here a rank holds its block as a plain
tensor: :func:`place_global` cuts it out of the global array (which
every rank computes identically — the seeded init or the same imported
weights), :func:`place_process_local` takes the rank's own batch rows
as its block, :func:`shard` and :func:`gather` go between a global
tensor and its blocks, and :func:`reshard` — the counterpart of
``with_sharding_constraint`` — moves a block from one layout to another
with the differentiable collectives of ``parallel/collectives.py``:
an all-gather for the axes the source splits a dimension over and the
destination does not (one collective a run of them, over the run's
group in the entry's order; its backward takes the rank's slice: the
gathered value feeds computation replicated over those axes — or, for
the axes named ``partial``, a reduce-scatter of a gradient each rank
holds a part of), then the rank's slice for the axes the destination
adds (backward: all-gather).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..op import TABLE, Op, WeightSpec
from . import collectives as C
from .pconfig import OpStrategy

Spec = Tuple


def spec_for_axes(axes: Sequence[Optional[str]], strategy: OpStrategy,
                  mesh, shape: Optional[Sequence[int]] = None) -> Spec:
    """Map each logical axis through the strategy: a mesh axis the mesh
    lacks, one an earlier dimension took, or one whose size does not
    divide the dimension leaves it whole; trailing Nones trimmed."""
    entries = []
    used = set()
    for i, ax in enumerate(axes):
        m = strategy.mesh_axis_for(ax)
        if m is None:
            entries.append(None)
            continue
        names = (m,) if isinstance(m, str) else tuple(m)
        names = tuple(n for n in names
                      if n in mesh.shape and n not in used)
        if not names:
            entries.append(None)
            continue
        if shape is not None:
            size = 1
            for n in names:
                size *= mesh.shape[n]
            if shape[i] % size != 0:
                entries.append(None)
                continue
        used.update(names)
        entries.append(names[0] if len(names) == 1 else names)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def op_output_sharding(op: Op, strategy: OpStrategy, mesh) -> list:
    """The spec of each output of ``op`` (JAX's pin)."""
    return [spec_for_axes(axes, strategy, mesh, op.outputs[i].shape)
            for i, axes in enumerate(op.output_axes())]


def weight_sharding(spec: WeightSpec, strategy: OpStrategy, mesh) -> Spec:
    return spec_for_axes(spec.axes, strategy, mesh, spec.shape)


def effective_op_strategy(op: Op, strategy: OpStrategy,
                          mesh) -> OpStrategy:
    """JAX's rule: a device-placed stacked embedding shards its
    ``table`` axis over the whole mesh, in the mesh's axis order, so
    slot block d lives on rank d (ops/embedding.py
    ``DistributedEmbedding``)."""
    if mesh is not None and getattr(op, "placement", None):
        am = dict(strategy.axis_map)
        am[TABLE] = tuple(mesh.axis_names)
        return OpStrategy(am)
    return strategy


def batch_sharding(mesh, ndim: int, data_axis: str = "data") -> Spec:
    """An input batch: dim 0 over the data axis."""
    if data_axis not in mesh.shape:
        return ()
    return (data_axis,)


# ------------------------------------------------------------- blocks
def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _padded(spec: Spec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def gathered_axes(src: Spec, dst: Spec) -> set:
    """The mesh axes :func:`reshard` gathers from ``src`` to ``dst``:
    on each dimension the source's axes past the prefix the two
    entries share."""
    nd = max(len(src), len(dst))
    out = set()
    for have, want in zip(_padded(src, nd), _padded(dst, nd)):
        have, want = _names(have), _names(want)
        k = 0
        while k < min(len(have), len(want)) and have[k] == want[k]:
            k += 1
        out.update(have[k:])
    return out


def block_index(entry, bm) -> Tuple[int, int]:
    """(block index, block count) of this rank for one spec entry."""
    idx, parts = 0, 1
    for n in _names(entry):
        idx = idx * bm.axis_size(n) + bm.coord(n)
        parts *= bm.axis_size(n)
    return idx, parts


def shard(x, spec: Spec, bm):
    """This rank's block of a global tensor or numpy array (a
    contiguous copy for a tensor; the same array when nothing is
    split)."""
    if bm is None:
        return x
    for d, e in enumerate(_padded(spec, x.ndim)):
        idx, parts = block_index(e, bm)
        if parts == 1:
            continue
        if x.shape[d] % parts:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"into {parts} blocks ({spec})")
        n = x.shape[d] // parts
        sl = [slice(None)] * x.ndim
        sl[d] = slice(idx * n, (idx + 1) * n)
        x = x[tuple(sl)]
    if isinstance(x, torch.Tensor):
        return x.contiguous()
    return np.ascontiguousarray(x)


def gather(x: torch.Tensor, spec: Spec, bm) -> torch.Tensor:
    """The global tensor from every rank's block (every rank calls it;
    not differentiable): one gather a split dimension, over the group
    of its entry (its axes in the entry's order, so the blocks come
    back in block order)."""
    if bm is None:
        return x
    for d, e in enumerate(_padded(spec, x.dim())):
        names = _names(e)
        if names:
            x = C.gather_tensor(x, bm, _axis(names), d)
    return x


def _axis(names: tuple):
    """A run of axis names as one collective's axis: the name, or the
    tuple (a group in the run's order)."""
    return names[0] if len(names) == 1 else tuple(names)


def place_global(arr, spec: Spec, bm, device, dtype=None) -> torch.Tensor:
    """A host-computed GLOBAL array (identical on every rank) placed as
    this rank's block on ``device``."""
    block = shard(np.asarray(arr) if not isinstance(arr, torch.Tensor)
                  else arr, spec, bm)
    return torch.as_tensor(block, device=device, dtype=dtype)


def place_process_local(host, spec: Spec, bm, device=None, dtype=None):
    """This rank's batch rows as its block of the global batch (global
    = the ranks' rows concatenated in data-coordinate order). Raises
    for a layout that does not split the batch, as JAX's does on
    several processes: a replicated batch would install each rank's
    different rows as 'the same' array."""
    if bm is not None and bm.world > 1 and not any(
            _names(e) for e in spec):
        raise NotImplementedError(
            "multi-process batch placement needs a 'data' mesh axis to "
            "split the global batch; a replicated batch would combine "
            "different per-process data silently")
    if isinstance(host, torch.Tensor):
        return host.to(device=device or host.device,
                       dtype=dtype or host.dtype)
    return torch.as_tensor(np.asarray(host), device=device, dtype=dtype)


def reshard(x: torch.Tensor, src: Spec, dst: Spec, bm,
            partial: Sequence[str] = ()) -> torch.Tensor:
    """``x`` (this rank's block under ``src``) as its block under
    ``dst``, differentiably: gathers first, then slices. On each
    dimension the longest major prefix the two entries share stays; the
    rest of the source's axes are gathered, the minor ones first, each
    run of them in one collective over the run's group (in the entry's
    order); the axes the destination adds are sliced off in one step.

    ``partial`` names the axes over which the gradient reaching the
    gathered value is partial (a weight gathered over an axis that
    splits its op's input: each rank's gradient comes from its own
    rows). A gather over such an axis is ``gather_sum``, whose backward
    reduce-scatters — the one sum that gradient gets over that axis —
    and any other gather is ``all_gather``, whose backward takes the
    rank's slice of a gradient that is whole."""
    if bm is None:
        return x
    nd = x.dim()
    s, t = _padded(src, nd), _padded(dst, nd)
    if s == t:
        return x
    for d in range(nd):
        have, want = _names(s[d]), _names(t[d])
        k = 0
        while k < min(len(have), len(want)) and have[k] == want[k]:
            k += 1
        rest = list(have[k:])
        while rest:
            # the longest minor run of one kind (partial or not)
            kind = rest[-1] in partial
            j = len(rest)
            while j > 0 and (rest[j - 1] in partial) == kind:
                j -= 1
            run = _axis(tuple(rest[j:]))
            x = (C.gather_sum if kind else C.all_gather)(x, bm, run, d)
            del rest[j:]
        s[d] = have[:k] or None
    for d in range(nd):
        have, want = _names(s[d]), _names(t[d])
        if want[len(have):]:
            x = C.split(x, bm, _axis(want[len(have):]), d)
    return x
