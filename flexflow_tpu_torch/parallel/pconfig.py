"""Per-op parallelization strategies; counterpart of
``flexflow_tpu/parallel/pconfig.py``, whole.

A strategy maps each op's logical axes (op.py's ``SAMPLE``,
``CHANNEL_OUT``, ...) onto the axes of a mesh description
(parallel/mesh.py ``MeshShape``); split counts follow from the mesh
axis sizes, explicit device ids from the mesh layout. ``ParallelConfig``
is the reference's per-op view (strategy file I/O). ``Strategy.save``
and ``Strategy.load`` write and read the JAX package's JSON, so a
strategy file written by either package loads in the other. The port
prices, searches and exports strategies, and executes them on a mesh
bound to a process group (core/executor.py); on one device nothing is
sharded.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional


@dataclasses.dataclass
class ParallelConfig:
    """Compatibility view of one op's placement (reference config.h:47-73)."""

    device_type: str = "tpu"
    dims: List[int] = dataclasses.field(default_factory=lambda: [1])
    device_ids: List[int] = dataclasses.field(default_factory=lambda: [0])

    @property
    def num_parts(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def is_data_parallel(self) -> bool:
        # reference simulator.cc:28-40: DP = only the sample (outermost
        # logical, innermost stored) dim is split. We store NumPy order, so
        # DP = only dims[0] split.
        return self.num_parts == self.dims[0]


DEVICE_KEY = "__devices__"


@dataclasses.dataclass
class OpStrategy:
    """Maps an op's logical axes to mesh axes. axis_map values may be a
    mesh axis name, a tuple of axis names (multi-axis sharding), or None.

    Device-explicit placement (the reference's `ParallelConfig.device_ids`,
    include/config.h:47-73 — what lets DLRM pin each embedding table to
    one device): the reserved `__devices__` axis_map entry binds the op to
    an explicit device-index tuple instead of the mesh-uniform SPMD
    program. The simulator gives such ops their own compute resources
    (concurrency across disjoint devices) and the cost model prices the
    gather of their outputs; see search/cost_model.py."""

    axis_map: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if DEVICE_KEY in self.axis_map:  # normalize for keying/dedup
            self.axis_map[DEVICE_KEY] = tuple(self.axis_map[DEVICE_KEY])

    @property
    def device_ids(self) -> Optional[tuple]:
        """Explicit device placement, or None for mesh-uniform SPMD."""
        return self.axis_map.get(DEVICE_KEY)

    def mesh_axis_for(self, logical_axis: Optional[str]):
        if logical_axis is None:
            return None
        return self.axis_map.get(logical_axis)

    def copy(self) -> "OpStrategy":
        return OpStrategy(dict(self.axis_map))


class Strategy:
    """Global strategy: op name -> OpStrategy, plus a default.

    The default maps `sample` to the mesh's `data` axis — exactly the
    reference's seeded data-parallel default (mapper.cc:118-145).
    """

    def __init__(self, op_strategies: Optional[Dict[str, OpStrategy]] = None,
                 default: Optional[OpStrategy] = None):
        self.op_strategies: Dict[str, OpStrategy] = op_strategies or {}
        self.default = default or OpStrategy({"sample": "data"})
        # search-discovered pipeline lowering that cannot ride per-op
        # pins (interleaved auto-cut: v stages per device) — carried so
        # --export/--import round-trips the whole winning plan:
        # {"stages": D, "virtual_stages": v, "schedule": "1f1b",
        #  "microbatches": M}. compile() applies it to the config knobs
        # its auto-cut lowering reads.
        self.pipeline: Optional[Dict] = None

    def for_op(self, op_name: str) -> OpStrategy:
        return self.op_strategies.get(op_name, self.default)

    def set(self, op_name: str, strategy: OpStrategy) -> None:
        self.op_strategies[op_name] = strategy

    def copy(self) -> "Strategy":
        out = Strategy(
            {k: v.copy() for k, v in self.op_strategies.items()},
            self.default.copy(),
        )
        out.pipeline = dict(self.pipeline) if self.pipeline else None
        return out

    # ---- file I/O ----
    # Native format is JSON ({"default": {...}, "ops": {name: axis_map}}).
    # The reference's plain-text format (strategy.cc:95-189) is also
    # readable/writable for tooling familiarity via to_text/from_text.

    def save(self, path: str) -> None:
        data = {
            "format": "flexflow_tpu_strategy_v1",
            "default": self.default.axis_map,
            "ops": {k: v.axis_map for k, v in self.op_strategies.items()},
        }
        if self.pipeline:
            data["pipeline"] = self.pipeline
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    @staticmethod
    def load(path: str) -> "Strategy":
        with open(path) as f:
            data = json.load(f)
        out = Strategy(
            {k: OpStrategy(v) for k, v in data.get("ops", {}).items()},
            OpStrategy(data.get("default", {"sample": "data"})),
        )
        pl = data.get("pipeline")
        if pl is not None:
            # fail at load with the file in hand, not deep in compile
            if not isinstance(pl, dict) \
                    or not isinstance(pl.get("stages"), int) \
                    or pl["stages"] < 1:
                raise ValueError(
                    f"{path}: \"pipeline\" must be an object with an "
                    f"int \"stages\" >= 1 (got {pl!r})")
            out.pipeline = pl
        return out

    def __repr__(self):
        return (f"Strategy(default={self.default.axis_map}, "
                f"{len(self.op_strategies)} op overrides)")


def placement_assignment(tables: int, devices: int, scheme: str) -> tuple:
    """Per-table device assignment schemes — the single source the MCMC
    candidates (search/mcmc.py) and the strategy generator
    (tools/gen_dlrm_strategy.py) both draw from, so the generator's
    output always lies inside the search space (reference
    dlrm_strategy.py emits what its search consumed, likewise)."""
    if tables < 1 or devices < 1:
        raise ValueError(
            f"tables and devices must be >= 1, got {tables}/{devices}")
    if scheme == "round_robin":
        return tuple(t % devices for t in range(tables))
    if scheme == "blocked":
        return tuple(min(t * devices // tables, devices - 1)
                     for t in range(tables))
    if scheme == "one_device":
        return (0,) * tables
    raise ValueError(f"unknown placement scheme {scheme!r}")


DATA_PARALLEL = Strategy()


def sequence_parallel_strategy(seq_axis: str = "seq") -> Strategy:
    """SP/CP: activations sharded over the sequence dim; attention runs
    as ring or all-to-all attention over `seq_axis` (``sp_attention``;
    new capability vs the reference, SURVEY.md 2.4)."""
    return Strategy(default=OpStrategy({"sample": "data",
                                        "seq": seq_axis}))


def megatron_strategy(model_axis: str = "model") -> Strategy:
    """TP default: split channel_out/head/vocab over the model axis (the
    reference reached the same placement through MCMC discovering
    out-channel splits for Linear, linear.cu:1074-1107)."""
    return Strategy(default=OpStrategy({
        "sample": "data",
        "channel_out": model_axis,
        "head": model_axis,
        "vocab": model_axis,
    }))
