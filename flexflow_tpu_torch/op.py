"""Op base class.

Counterpart of ``flexflow_tpu/op.py`` for single-device training: an op
declares its output shapes and trainable weights and computes its
forward as a plain function of torch tensors; autograd supplies the
backward. Non-trainable state (BatchNorm's running statistics) is
declared by ``state_specs`` and threaded through ``OpContext``'s
``state_in``/``state_out``. ``flops`` is the JAX op's forward count, which
the smoke's MFU reads; the JAX package's logical-axis and byte hooks
wait for parallel training and the search.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import torch

from .tensor import Tensor

if TYPE_CHECKING:
    from .model import FFModel


@dataclasses.dataclass
class WeightSpec:
    """Declaration of one trainable parameter of an op.

    ``fan_in``/``fan_out`` override shape-derived fans for fan-scaled
    initializers (attention's stacked (E, H, D) weights)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    initializer: str = "glorot"  # name into core.initializers
    fan_in: Optional[int] = None
    fan_out: Optional[int] = None


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
                 "state_out", "nhwc_in", "nhwc_out")

    def __init__(self, training: bool, rng=None, seq_length: int = -1,
                 state_in: Optional[dict] = None, nhwc_in: bool = False,
                 nhwc_out: bool = False):
        self.training = training
        self.rng = rng
        self.seq_length = seq_length
        self.state_in = state_in or {}
        self.state_out: dict = {}
        self.nhwc_in = nhwc_in
        self.nhwc_out = nhwc_out


class Op:
    """Base class for all layers. Ops own no tensors, only shapes and
    attributes; parameters live in the executor's
    ``{op_name: {weight_name: tensor}}`` tree."""

    op_type: str = "op"

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

    def flops(self) -> float:
        """Forward FLOPs of the whole op (the JAX op's count)."""
        return 0.0

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
