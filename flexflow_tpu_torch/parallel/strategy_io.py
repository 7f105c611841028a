"""Reference-format strategy file I/O; counterpart of
``flexflow_tpu/parallel/strategy_io.py``, whole.

The reference persists strategies as plain text (strategy.cc:95-189):

    <num_ops>
    <op_name> <device_type> <nDims> <dim_0> ... <dim_n-1> <id_0> ... <id_k-1>

keyed at runtime by hash(op name) -> MappingTagID. We keep the same
format for tooling familiarity: export derives per-dim split counts and
device ids from (strategy, mesh); import reconstructs an axis map by
matching split counts back onto the op's logical axes.

The native format remains JSON (Strategy.save/load) — it round-trips the
axis maps exactly; this module is the compatibility layer. The device
type tokens ("tpu", "tpu_pin") are the JAX package's, so a file written
by either package loads in the other. The FFProtoBuf reader carries its
own copy of the protobuf wire scanner (``_varint``/``_fields``).
"""

from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np

from typing import Tuple

from ..op import Op
from .pconfig import DEVICE_KEY, OpStrategy, ParallelConfig, Strategy


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated protobuf: buffer ends mid-varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes):
    """Yield (field_no, wire_type, value); value is int (wire 0/1/5 —
    1/5 returned as raw little-endian ints) or bytes (wire 2)."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _varint(buf, pos)
        field_no, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _varint(buf, pos)
        elif wt == 1:
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wt == 5:
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        elif wt == 2:
            ln, pos = _varint(buf, pos)
            if ln > n - pos:
                raise ValueError(
                    f"truncated protobuf: field {field_no} declares "
                    f"{ln} bytes, {n - pos} remain")
            val = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field_no, wt, val


def op_parallel_config(op: Op, strategy: OpStrategy, mesh) -> ParallelConfig:
    """Derive the reference-style view: per-output-dim split counts +
    explicit device ids (row-major over the mesh submesh used).

    A device-explicit OpStrategy (the reference's own device_ids,
    config.h:47-73) exports unsplit dims with its literal device list —
    exactly how the DLRM strategy files pinned tables
    (dlrm_strategy.cc:1-50)."""
    out_axes = op.output_axes()[0] if op.outputs else ()
    out_shape = op.outputs[0].shape if op.outputs else ()
    if strategy.device_ids:
        # device_type "tpu_pin" marks an EXPLICIT placement: the format
        # cannot otherwise distinguish "pinned to device 0" from the
        # default single-part [0] device list
        if any(k != DEVICE_KEY for k in strategy.axis_map):
            warnings.warn(
                f"strategy for {op.name!r} combines mesh-axis splits "
                f"with explicit device ids; the text format carries the "
                f"placement only (mirror of the lossy import case)")
        return ParallelConfig(device_type="tpu_pin",
                              dims=[1] * max(1, len(out_axes)),
                              device_ids=list(strategy.device_ids))
    dims = []
    used_axes = []
    for i, ax in enumerate(out_axes):
        m = strategy.mesh_axis_for(ax)
        if isinstance(m, str) and m in mesh.shape \
                and out_shape[i] % mesh.shape[m] == 0 \
                and m not in used_axes:
            dims.append(mesh.shape[m])
            used_axes.append(m)
        else:
            dims.append(1)
    n_parts = int(np.prod(dims)) if dims else 1
    device_ids = list(range(n_parts))
    return ParallelConfig(device_type="tpu", dims=dims,
                          device_ids=device_ids)


def save_strategies_to_file(model, strategy: Strategy, mesh,
                            path: str) -> None:
    """Reference text format (strategy.cc:126-189)."""
    lines = [str(len(model.ops))]
    for op in model.ops:
        pc = op_parallel_config(op, strategy.for_op(op.name), mesh)
        parts = [op.name, pc.device_type, str(len(pc.dims))]
        parts += [str(d) for d in pc.dims]
        parts += [str(i) for i in pc.device_ids]
        lines.append(" ".join(parts))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# REFERENCE-native formats (VERDICT r3 #10): the reference persists
# strategies two ways — the FFProtoBuf.Strategy protobuf the DLRM
# examples ship (examples/cpp/DLRM/strategies/*.pb, schema in
# dlrm_strategy.py: Op{name=1, device_type=2, dims=3, device_ids=4})
# and the plain-text token stream of strategy.cc:95-189
# (<count> then per op: name, device_type, nDims, dims..., n, ids...).
# Both import directly onto OpStrategy so reference artifacts replay.
# ---------------------------------------------------------------------------

def parse_reference_pb(path: str) -> List[tuple]:
    """Decode FFProtoBuf.Strategy with the in-tree protobuf wire reader
    (no protobuf dependency). Returns [(name, device_type, dims, ids)]."""
    with open(path, "rb") as f:
        buf = f.read()

    def ints(val):  # repeated varint: non-packed int or packed bytes
        if isinstance(val, int):
            return [val]
        out, pos = [], 0
        while pos < len(val):
            v, pos = _varint(val, pos)
            out.append(v)
        return out

    out = []
    for fno, wt, val in _fields(buf):
        if fno != 1:  # Strategy.ops
            continue
        if wt != 2:  # not a length-delimited message: wrong proto
            raise ValueError(
                f"{path}: field 1 has wire type {wt}, expected an "
                f"embedded Op message — not an FFProtoBuf.Strategy "
                f"file")
        name, dtype = "", 0
        dims: List[int] = []
        ids: List[int] = []
        for ofno, owt, oval in _fields(bytes(val)):
            if ofno == 1:
                name = oval.decode()
            elif ofno == 2:
                dtype = int(oval)
            elif ofno == 3:
                dims.extend(ints(oval))
            elif ofno == 4:
                ids.extend(ints(oval))
        if not name:
            raise ValueError(
                f"{path}: Op entry without a name — not an "
                f"FFProtoBuf.Strategy file")
        out.append((name, dtype, dims, ids))
    return out


def parse_reference_text(path: str) -> List[tuple]:
    """Token-stream parser mirroring load_strategies_from_file
    (strategy.cc:95-144): whitespace-insensitive, count-prefixed."""
    with open(path) as f:
        toks = f.read().split()
    it = iter(toks)
    n_ops = int(next(it))
    out = []
    for _ in range(n_ops):
        name = next(it)
        dtype = int(next(it))
        ndims = int(next(it))
        dims = [int(next(it)) for _ in range(ndims)]
        n_ids = int(next(it))
        ids = [int(next(it)) for _ in range(n_ids)]
        out.append((name, dtype, dims, ids))
    return out


def _dims_to_axis_map(op: Op, dims: List[int], mesh,
                      legion_order: bool = False) -> Dict[str, str]:
    """Per-dim split counts -> axis map: each >1 split matches the
    first unused mesh axis of that size (sorted by name for
    determinism). `legion_order` reverses first — reference files store
    the sample dim LAST (Legion order), our own text format stores
    NumPy order."""
    out_axes = op.output_axes()[0] if op.outputs else ()
    seq = list(reversed(dims)) if legion_order else list(dims)
    axis_map: Dict[str, str] = {}
    used = set()
    for i, split in enumerate(seq):
        if split <= 1 or i >= len(out_axes) or out_axes[i] is None:
            continue
        for mesh_ax, size in sorted(mesh.shape.items()):
            if size == split and mesh_ax not in used:
                axis_map[out_axes[i]] = mesh_ax
                used.add(mesh_ax)
                break
    return axis_map


# family names the reference uses for shared entries (one "linear"
# entry governs every Linear op via name-hash lookup)
_FAMILY_TYPES = {"linear": "linear", "concat": "concat",
                 "conv2d": "conv2d", "embedding": "embedding",
                 "attention": "multihead_attention"}


def load_reference_strategy_file(model, mesh, path: str) -> Strategy:
    """Import a REFERENCE strategy artifact (protobuf .pb or
    strategy.cc text) onto this model:

    * exact-name entries bind to the same-named op;
    * `embedding<N>` entries with whole-op pins collapse onto a
      `distributed_embedding` op's per-table `__devices__` tuple (the
      executable form of the reference's per-GPU DLRM tables);
    * family entries ("linear", "concat", ...) bind to every op of
      that type, reproducing the reference's shared-name lookup;
    * identity device lists with >1 splits become mesh-axis mappings;
      non-identity lists become explicit placements.
    """
    entries = (parse_reference_pb(path) if path.endswith(".pb")
               else parse_reference_text(path))
    strat = Strategy()
    ops_by_name = {op.name: op for op in model.ops}

    # collapse embedding<N> whole-op pins onto stacked-table ops
    emb_entries = sorted(
        ((int(name[len("embedding"):]), ids) for name, _d, dims, ids
         in entries
         if name.startswith("embedding")
         and name[len("embedding"):].isdigit()
         and len(ids) == 1 and all(d == 1 for d in dims)),
        key=lambda t: t[0])
    if emb_entries:
        table_ids = tuple(ids[0] for _n, ids in emb_entries)
        for op in model.ops:
            if op.op_type == "distributed_embedding" \
                    and getattr(op, "num_tables", 0) == len(table_ids):
                strat.set(op.name, OpStrategy({DEVICE_KEY: table_ids}))
                break

    import re

    def apply(op, name, dims, ids):
        n_parts = int(np.prod(dims)) if dims else 1
        axis_map = _dims_to_axis_map(op, dims, mesh, legion_order=True)
        if ids and ids != list(range(n_parts)) and not axis_map:
            axis_map = {DEVICE_KEY: tuple(ids)}
        elif ids and ids != list(range(n_parts)) and axis_map:
            warnings.warn(
                f"reference strategy {name!r}: explicit device ids "
                f"{ids} on a split op load as the split only")
        strat.set(op.name, OpStrategy(axis_map))

    # pass 1: exact-name entries (the reference's hash lookup gives an
    # op its same-named entry — these always win)
    for name, _dtype, dims, ids in entries:
        op = ops_by_name.get(name)
        if op is None:
            continue
        if op.name in strat.op_strategies:  # collapsed table pins win
            continue
        apply(op, name, dims, ids)

    # pass 2: family / indexed bindings, never overwriting pass 1
    for name, _dtype, dims, ids in entries:
        if name in ops_by_name:
            continue
        if name in _FAMILY_TYPES:
            targets = [op for op in model.ops
                       if op.op_type == _FAMILY_TYPES[name]]
        elif name.startswith("embedding") \
                and name[len("embedding"):].isdigit():
            # bind to the standalone embedding op with the SAME
            # trailing index (suffix matching would alias 1 and 11)
            idx = int(name[len("embedding"):])
            targets = []
            for op in model.ops:
                if op.op_type != "embedding":
                    continue
                m = re.search(r"(\d+)$", op.name)
                if m and int(m.group(1)) == idx:
                    targets.append(op)
        else:
            continue
        for op in targets:
            if op.name in strat.op_strategies:
                continue  # exact entries / table collapse win
            apply(op, name, dims, ids)
    return strat


def load_strategies_from_file(model, mesh, path: str) -> Strategy:
    """Rebuild an axis map from the text format: a >1 split on dim i maps
    that dim's logical axis to the smallest matching mesh axis."""
    with open(path) as f:
        tokens = f.read().split("\n")
    n = int(tokens[0].strip())
    ops_by_name = {op.name: op for op in model.ops}
    strat = Strategy()
    for line in tokens[1:n + 1]:
        parts = line.split()
        name, dev_type = parts[0], parts[1]
        ndims = int(parts[2])
        dims = [int(x) for x in parts[3:3 + ndims]]
        device_ids = [int(x) for x in parts[3 + ndims:]]
        op = ops_by_name.get(name)
        if op is None:
            continue
        axis_map: Dict[str, str] = _dims_to_axis_map(op, dims, mesh)
        # explicit placement: the "tpu_pin" device-type marker, or an
        # unsplit op whose device list differs from the default range
        # (how the reference's DLRM strategy files pin tables)
        n_parts = int(np.prod(dims)) if dims else 1
        if device_ids and (dev_type == "tpu_pin"
                           or (not axis_map
                               and device_ids != list(range(n_parts)))):
            axis_map = {DEVICE_KEY: tuple(device_ids)}
        elif (axis_map and device_ids
                and device_ids != list(range(n_parts))):
            # split AND explicitly placed: the mesh-axis mapping cannot
            # carry the id list — be honest about the approximation
            warnings.warn(
                f"strategy file op {name!r}: explicit device ids "
                f"{device_ids} on a split op are not representable as a "
                f"mesh-axis mapping; loading the split only")
        strat.set(name, OpStrategy(axis_map))
    return strat
