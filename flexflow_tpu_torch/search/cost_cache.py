"""Persistent cost cache of the search (``flexflow_tpu/search/
cost_cache.py``, whole).

Cost rows are serialized to disk keyed by

    (signature, shard/axis-map signature, machine-model fingerprint)

so repeated searches skip re-deriving costs. The fingerprint covers the
MachineSpec numbers, the efficiency factors, the torus/DCN layout, the
mesh shape and the pricing code itself: any change to what the cost
formulas would see invalidates the entries (rows of other fingerprints
stay in the file, unused). Its writers are the training simulator's
per-(op, axis map) rows (search/simulator.py) and the serve placement
search's step prices (search/serve_place.py).

Path: ``costcache.json`` under the kernels' git-ignored build directory
(``flexflow_tpu_torch/_build``; root overridable with
``FLEXFLOW_TORCH_CACHE``, file with FFConfig.cost_cache_file). One
CostCache object per path is shared process-wide, under a lock.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from typing import Dict, Optional

# row layout of a persisted OpCost; adding a field widens the row, and
# get()'s length check makes every pre-widening row a clean miss (the
# COST_MODEL_VERSION bump in the fingerprint retires them anyway)
_COST_FIELDS = ("fwd", "bwd", "fwd_comm", "bwd_comm", "sync", "mem",
                "update", "sync_bytes")


_PRICING_SRC_HASH: Optional[str] = None


def _pricing_source_hash() -> str:
    """Hash of the pricing-code sources (cost_model, machine_model,
    op_measure, serve_place): an edited cost formula changes the fingerprint
    automatically, so stale cache entries can never be served by a
    forgotten COST_MODEL_VERSION bump. Memoized per process."""
    global _PRICING_SRC_HASH
    if _PRICING_SRC_HASH is None:
        h = hashlib.sha256()
        base = os.path.dirname(os.path.abspath(__file__))
        for mod in ("cost_model.py", "machine_model.py",
                    "op_measure.py", "serve_place.py"):
            try:
                with open(os.path.join(base, mod), "rb") as f:
                    h.update(f.read())
            except OSError:
                h.update(mod.encode())  # zipped install: name only
        _PRICING_SRC_HASH = h.hexdigest()[:16]
    return _PRICING_SRC_HASH


def machine_fingerprint(mm, mesh=None, precision=None,
                        overlap=None, serve=None) -> str:
    """Stable short hash of everything the cost formulas read from the
    machine model and mesh, plus the pricing code itself (the JAX
    package's blob, field for field).

    `precision` is the (compute_dtype, param_dtype) policy costs were
    priced under, `overlap` the runtime's sync-overlap configuration,
    and `serve` the serve-placement signature (search/serve_place: KV
    and activation dtypes, adapter geometry, the traffic and SLO tuple
    of the mesh search): a flip of any is a guaranteed miss."""
    from .cost_model import COST_MODEL_VERSION
    spec = {f.name: getattr(mm.spec, f.name, None)
            for f in dataclasses.fields(mm.spec)}
    blob = {
        "costmodel_v": COST_MODEL_VERSION,
        "pricing_src": _pricing_source_hash(),
        "spec": {k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in spec.items()},
        "efficiency": dict(sorted(mm.efficiency.items())),
        "dtype_flops_scale": dict(sorted(
            getattr(mm, "dtype_flops_scale", {}).items())),
        "dcn_axes": list(mm.dcn_axes),
        "axis_topology": {k: list(v)
                          for k, v in sorted(mm.axis_topology.items())},
        "mesh": (sorted(mesh.shape.items()) if mesh is not None else None),
        "precision": (list(str(p) for p in precision)
                      if precision is not None else None),
        "overlap": (list(overlap) if overlap is not None else None),
        "serve": (list(serve) if serve is not None else None),
    }
    raw = json.dumps(blob, sort_keys=True, default=str)
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def default_path() -> str:
    root = os.environ.get("FLEXFLOW_TORCH_CACHE") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "_build")
    return os.path.join(root, "costcache.json")


class CostCache:
    """Disk-backed {entry key -> OpCost} map, scoped to one machine
    fingerprint. Pipeline-expanded costs (OpCost.pipeline) carry nested
    schedule state and are never persisted."""

    _open: Dict[str, "CostCache"] = {}
    _open_lock = threading.Lock()

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        # fingerprint -> {key -> [len(_COST_FIELDS) floats]}
        self._data: Dict[str, Dict[str, list]] = {}
        self._dirty = False
        self._loaded = False
        self.hits = 0
        self.misses = 0

    @classmethod
    def open(cls, path: Optional[str] = None) -> "CostCache":
        """Process-wide shared instance per path (parallel chains and
        mesh-shape sweeps must see one read-mostly store)."""
        path = path or default_path()
        with cls._open_lock:
            if path not in cls._open:
                cls._open[path] = cls(path)
            return cls._open[path]

    # ---- keying ----
    @staticmethod
    def entry_key(op_sig: str, axis_sig, extra=()) -> str:
        raw = json.dumps([op_sig, list(axis_sig), list(extra)],
                         default=str)
        return hashlib.sha256(raw.encode()).hexdigest()[:24]

    # ---- I/O ----
    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return             # no cache yet — the common first run
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            # a corrupted / truncated store (crash mid-write on an old
            # build, disk fault, manual edit) must never crash a
            # search: warn, start empty, and let the next flush()
            # REBUILD the file wholesale (see flush's corrupt-merge
            # path). The cache is a pure accelerator — losing it costs
            # re-derivation, never correctness.
            import warnings
            warnings.warn(
                f"cost cache {self.path} is unreadable "
                f"({type(e).__name__}: {e}); rebuilding it from scratch")
            self._dirty = True   # next flush overwrites the wreck
            return
        if isinstance(data, dict):
            # row-level validation happens in get() (len check); here
            # just drop structurally-foreign subtrees
            self._data = {fp: dict(entries)
                          for fp, entries in data.items()
                          if isinstance(entries, dict)}

    def get(self, fingerprint: str, key: str):
        from .cost_model import OpCost
        with self._lock:
            self._ensure_loaded()
            row = self._data.get(fingerprint, {}).get(key)
            if row is None or len(row) != len(_COST_FIELDS):
                self.misses += 1
                return None
            self.hits += 1
            return OpCost(**{f: float(v)
                             for f, v in zip(_COST_FIELDS, row)})

    def put(self, fingerprint: str, key: str, cost) -> None:
        if cost.pipeline is not None:
            return
        with self._lock:
            self._ensure_loaded()
            self._data.setdefault(fingerprint, {})[key] = [
                float(getattr(cost, f)) for f in _COST_FIELDS]
            self._dirty = True

    def flush(self) -> None:
        """Atomic write (tmp + rename), merging entries another process
        may have written since we loaded. Unwritable cache paths never
        abort a search (same policy as measure.py)."""
        with self._lock:
            if not self._dirty:
                return
            try:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                merged = {}
                try:
                    with open(self.path) as f:
                        on_disk = json.load(f)
                    if isinstance(on_disk, dict):
                        merged = {fp: e for fp, e in on_disk.items()
                                  if isinstance(e, dict)}
                except FileNotFoundError:
                    pass
                except (OSError, json.JSONDecodeError,
                        UnicodeDecodeError):
                    # corrupt on-disk store: do not merge garbage —
                    # this flush rewrites it wholesale from the
                    # in-memory entries (the rebuild _ensure_loaded
                    # promised)
                    import warnings
                    warnings.warn(
                        f"cost cache {self.path} was corrupt at flush; "
                        f"overwriting with this process's entries")
                for fp, entries in self._data.items():
                    merged.setdefault(fp, {}).update(entries)
                # temp-then-os.replace: a kill mid-flush leaves the
                # previous complete store, never a truncation
                from ..utils.telemetry import write_json_atomic
                write_json_atomic(self.path, merged)
                self._dirty = False
            except OSError:
                pass

    def stats(self) -> Dict[str, int]:
        with self._lock:
            n = sum(len(v) for v in self._data.values())
            return {"hits": self.hits, "misses": self.misses,
                    "entries": n}
