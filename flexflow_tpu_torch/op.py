"""Op base class.

Counterpart of ``flexflow_tpu/op.py`` for single-device training: an op
declares its output shapes and trainable weights and computes its
forward as a plain function of torch tensors; autograd supplies the
backward. Non-trainable state (BatchNorm's running statistics) is
declared by ``state_specs`` and threaded through ``OpContext``'s
``state_in``/``state_out``; an op with ``has_aux_loss`` sets
``OpContext.aux_loss`` in training, which the executor adds to the
loss. ``flops`` is the JAX op's forward count, which
the smoke's MFU and the cost model read.

The sharding contract is the JAX package's: ``output_axes`` and
``input_axes`` name each tensor dimension by a logical axis
(``SAMPLE``, ``CHANNEL_OUT``, ...), ``WeightSpec.axes`` names each
weight dimension, and ``bytes_accessed`` / ``weight_bytes`` feed the
cost model (search/cost_model.py). A strategy maps those logical axes
onto the axes of a mesh; the search prices it.

On an executing mesh (parallel/mesh.BoundMesh) each op runs its *local
rule*: from the blocks of its inputs in the layouts it declares
(:meth:`Op.mesh_input_specs`) and of its weights in the layouts it
reads them in (:meth:`Op.mesh_weight_specs`), it computes the blocks of
its outputs in the layouts of :meth:`Op.mesh_output_specs`, calling the
collectives of parallel/collectives.py where GSPMD would have inserted
them. The default rule is data parallelism: inputs and outputs split
on their ``sample`` dimension over ``data`` and every weight whole, a
local computation for the ops whose rows are independent. The ops whose
rows are not (BatchNorm, Dropout's counter, Reshape, the MoE ops) and
the tensor-parallel ones (Linear, Conv2D and LSTM ``channel_out``,
attention ``head``, Embedding ``vocab``) override it in their modules; ``OpContext.mesh``
and ``OpContext.strategy`` hand them the mesh and their strategy.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import torch

from .tensor import Tensor

if TYPE_CHECKING:
    from .model import FFModel

# Logical axis vocabulary (the JAX package's): "sample" is the batch
# dim (splitting it is data parallelism), "channel*" splits are tensor
# parallelism, "seq" sequence parallelism, "expert" expert parallelism,
# "layer" pipeline stages, "table" stacked embedding tables
SAMPLE = "sample"
CHANNEL = "channel"
CHANNEL_IN = "channel_in"
CHANNEL_OUT = "channel_out"
SEQ = "seq"
HEAD = "head"
HEIGHT = "height"
WIDTH = "width"
EXPERT = "expert"
VOCAB = "vocab"
LAYER = "layer"
TABLE = "table"
REPLICA = None  # a dimension never split


def _sample_only(axes):
    return tuple(a if a == SAMPLE else None for a in axes)


def _sample_seq(axes):
    return tuple(a if a in (SAMPLE, SEQ) else None for a in axes)


def tp_axis(op, strategy, mesh, weight: str, dim: int):
    """The mesh axis — a name, or a tuple of names in the entry's order
    — that ``op``'s tensor-parallel rule runs over for dimension ``dim``
    of weight ``weight``, or None. It is the weight's stored entry
    (JAX's weight_sharding) less the axes that split the op's input
    (:func:`input_split_axes`): the rank stores its block over the
    product of the entry's axes, and where an axis of the entry also
    splits the input (``data`` in the FSDP layout ``("model",
    "data")``), the rule runs over the axes left and the weight is
    gathered over that axis before use (core/executor.py)."""
    if mesh is None or strategy is None:
        return None
    from .parallel.sharding import _names, weight_sharding
    spec = weight_sharding(op.weight_specs()[weight], strategy, mesh)
    entry = spec[dim] if dim < len(spec) else None
    split = input_split_axes(op, strategy, mesh)
    names = tuple(n for n in _names(entry) if n not in split)
    if not names:
        return None
    return names[0] if len(names) == 1 else names


def input_split_axes(op, strategy, mesh) -> set:
    """The mesh axes the op's inputs are split over on the dimensions
    its local rule reads in blocks (the batch, and the sequence of a
    :attr:`Op.seq_local` op)."""
    from .parallel.sharding import _names, spec_for_axes
    return {n for ax, t in zip(op.input_axes(), op.inputs)
            for e in spec_for_axes(op._local_axes(ax), strategy, mesh,
                                   t.shape)
            for n in _names(e)}


@dataclasses.dataclass
class WeightSpec:
    """Declaration of one trainable parameter of an op.

    ``fan_in``/``fan_out`` override shape-derived fans for fan-scaled
    initializers (attention's stacked (E, H, D) weights). ``axes``
    names the logical axis of each dimension (None: never split)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    initializer: str = "glorot"  # name into core.initializers
    fan_in: Optional[int] = None
    fan_out: Optional[int] = None
    axes: Tuple[Optional[str], ...] = None  # logical axis per dim
    # a leading layer dimension whose slices initialize independently
    # (ops/pipeline.py's stacked blocks)
    stacked: bool = False

    def __post_init__(self):
        if self.axes is None:
            self.axes = tuple([None] * len(self.shape))


@dataclasses.dataclass
class StateSpec:
    """Non-trainable per-op state (BatchNorm's running statistics),
    held in the executor's ``states`` tree and written in place by each
    training step."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init_value: float = 0.0


class OpContext:
    """Per-invocation context handed to ``Op.forward``: training or
    not, the op's random stream (``rng``, a ``core.prng.OpRng`` of the
    step key and the op's fold-in value, or None outside a train step),
    the ``seq_length`` truncation, non-trainable state in and out, and
    the channels-last residency of ``conv_layout='NHWC'``: ``nhwc_in``
    says the op's 4-d inputs arrive in ``torch.channels_last`` memory,
    ``nhwc_out`` that its outputs should stay so (core/executor.py)."""

    __slots__ = ("training", "rng", "seq_length", "state_in",
                 "state_out", "nhwc_in", "nhwc_out", "aux_loss", "mesh",
                 "strategy", "batch_axis")

    def __init__(self, training: bool, rng=None, seq_length: int = -1,
                 state_in: Optional[dict] = None, nhwc_in: bool = False,
                 nhwc_out: bool = False, mesh=None, strategy=None,
                 batch_axis=None):
        self.training = training
        self.rng = rng
        self.seq_length = seq_length
        self.state_in = state_in or {}
        self.state_out: dict = {}
        self.nhwc_in = nhwc_in
        self.nhwc_out = nhwc_out
        # an f32 scalar an op adds to the objective (MoE's load-balancing
        # loss); the executor sums them into the loss in op order
        self.aux_loss = None
        # the executing mesh (parallel/mesh.BoundMesh) and the op's
        # OpStrategy, or None on one device
        self.mesh = mesh
        self.strategy = strategy
        # the mesh axis (a name or a tuple) the op's input batch is
        # split over, or None where the op reads the whole batch
        self.batch_axis = batch_axis

    def data_split(self) -> bool:
        """Whether the op's batch is split over a mesh axis
        (:attr:`batch_axis`; a one-rank axis included: its collectives
        still run)."""
        return self.mesh is not None and self.batch_axis is not None


class Op:
    """Base class for all layers. Ops own no tensors, only shapes and
    attributes; parameters live in the executor's
    ``{op_name: {weight_name: tensor}}`` tree."""

    op_type: str = "op"
    # sets OpContext.aux_loss in training; kept out of remat
    has_aux_loss: bool = False
    # the training output reads state_in (an EMA-style norm would): a
    # 1F1B pipeline cannot run it (core/staged.py)
    training_output_reads_state: bool = False

    def __init__(self, model: "FFModel", name: str,
                 inputs: Sequence[Tensor]):
        self.model = model
        self.name = name
        self.inputs: List[Tensor] = list(inputs)
        self.outputs: List[Tensor] = []
        self.attrs: Dict = {}

    def output_shapes(self) -> List[Tuple[int, ...]]:
        raise NotImplementedError

    def output_dtypes(self) -> List[torch.dtype]:
        src = self.inputs[0].dtype if self.inputs else torch.float32
        return [src for _ in self.output_shapes()]

    def weight_specs(self) -> Dict[str, WeightSpec]:
        return {}

    def state_specs(self) -> Dict[str, StateSpec]:
        return {}

    # ---- sharding contract ----
    def output_axes(self) -> List[Tuple[Optional[str], ...]]:
        """Logical axis name per output dim; default: sample on dim 0."""
        out = []
        for shp in [t.shape for t in self.outputs]:
            axes = [None] * len(shp)
            if len(shp) > 0:
                axes[0] = SAMPLE
            out.append(tuple(axes))
        return out

    def input_axes(self) -> List[Tuple[Optional[str], ...]]:
        """Logical axis name per input dim (used for resharding cost)."""
        out = []
        for t in self.inputs:
            axes = [None] * len(t.shape)
            if len(t.shape) > 0:
                axes[0] = SAMPLE
            out.append(tuple(axes))
        return out

    # ---- executing on a mesh (the local rule's layouts) ----
    # a position-local op: each position of a (batch, seq, ...) tensor
    # is computed from the same position of its inputs alone, so the
    # local rule may read and write blocks of the sequence
    seq_local: bool = False

    def _local_axes(self, axes):
        return _sample_seq(axes) if self.seq_local else _sample_only(axes)

    def mesh_input_specs(self, strategy, mesh) -> list:
        """The layout each input is read in: its ``sample`` dimension
        split as the strategy maps it (and its ``seq`` dimension, for a
        :attr:`seq_local` op), every other dimension whole."""
        from .parallel.sharding import spec_for_axes
        return [spec_for_axes(self._local_axes(ax), strategy, mesh,
                              t.shape)
                for ax, t in zip(self.input_axes(), self.inputs)]

    def mesh_output_specs(self, strategy, mesh) -> list:
        """The layout the local rule produces each output in: its
        ``sample`` dimension split (and ``seq``, for a :attr:`seq_local`
        op), every other dimension whole."""
        from .parallel.sharding import spec_for_axes
        return [spec_for_axes(self._local_axes(ax), strategy, mesh,
                              t.shape)
                for ax, t in zip(self.output_axes(), self.outputs)]

    def mesh_pin_specs(self, strategy, mesh) -> list:
        """The layout each output is pinned to where the executor pins
        it (JAX's ``op_output_sharding``); an op whose local rule writes
        an output whole that JAX's pin would cut keeps it whole."""
        from .parallel.sharding import op_output_sharding
        return op_output_sharding(self, strategy, mesh)

    def mesh_grad_axes(self, strategy, mesh) -> tuple:
        """The mesh axes this op's weight gradients are summed over: the
        axes its local rule's inputs are split over (ranks that differ
        on them compute from different rows or positions, so each holds
        a part of the gradient) — ``data``, and ``seq`` for a
        :attr:`seq_local` op on a sequence split. A rank that computes
        from its inputs read whole over an axis holds the whole
        gradient, which a sum over that axis would multiply by its
        size. In the mesh's axis order. A weight read gathered over one
        of these axes gets that sum from its gather's backward instead
        (core/executor.py ``_partial``)."""
        from .parallel.sharding import _names
        used = {n for spec in self.mesh_input_specs(strategy, mesh)
                for e in spec for n in _names(e)}
        return tuple(a for a in mesh.axis_names if a in used)

    def mesh_weight_specs(self, strategy, mesh) -> dict:
        """The layout each weight is read in: whole (a weight stored
        split is gathered, its gradient sliced back); the
        tensor-parallel ops read their split weights as stored."""
        return {k: () for k in self.weight_specs()}

    # ---- cost-model contract ----
    def flops(self) -> float:
        """Forward FLOPs of the whole op (the JAX op's count)."""
        return 0.0

    def bytes_accessed(self) -> float:
        total = 0
        for t in list(self.inputs) + list(self.outputs):
            total += t.size_bytes()
        for spec in self.weight_specs().values():
            n = 1
            for s in spec.shape:
                n *= s
            total += n * spec.dtype.itemsize
        return float(total)

    def weight_bytes(self) -> float:
        total = 0
        for spec in self.weight_specs().values():
            n = 1
            for s in spec.shape:
                n *= s
            total += n * spec.dtype.itemsize
        return float(total)

    def forward(self, params: Dict[str, torch.Tensor],
                xs: List[torch.Tensor], ctx: OpContext
                ) -> List[torch.Tensor]:
        raise NotImplementedError

    def finalize(self) -> None:
        """Create output Tensor handles from ``output_shapes``."""
        self.outputs = [
            Tensor(s, d, owner_op=self, owner_idx=i,
                   name=f"{self.name}:out{i}")
            for i, (s, d) in enumerate(zip(self.output_shapes(),
                                           self.output_dtypes()))]

    @property
    def output(self) -> Tensor:
        return self.outputs[0]

    def __repr__(self):
        ins = ", ".join(str(t.shape) for t in self.inputs)
        outs = ", ".join(str(t.shape) for t in self.outputs)
        return f"{type(self).__name__}({self.name}: [{ins}] -> [{outs}])"


# op_type -> class of every op the package defines (each op module
# decorates its classes), the JAX package's registry under its keys
OP_REGISTRY: Dict[str, type] = {}


def register_op(cls):
    """Class decorator: enter ``cls`` in :data:`OP_REGISTRY` under its
    ``op_type``."""
    OP_REGISTRY[cls.op_type] = cls
    return cls
