"""Sibling-conv grouping; counterpart of ``conv_sibling_groups`` in
``flexflow_tpu/core/fusion.py``. The rest of that module (fusion groups
and their sharding boundaries, ``perform_fusion``) belongs to parallel
training and is not ported: ``FFModel.compile`` raises when
``perform_fusion`` is set."""

from __future__ import annotations

from typing import Dict, List, Tuple


def conv_sibling_groups(model) -> List[List]:
    """Groups of Conv2D ops that read the SAME input tensor with the
    SAME geometry — the 1x1 branch heads of an Inception module. Each
    group runs as one conv with the kernels concatenated along
    channel-out (ops/conv.py ``merged_conv_forward``). Members come in
    ``model.ops`` order; the first is the group leader, which runs the
    merged conv at its walk position while the others take their slice.

    Grouping needs identical kernel, stride, padding, activation and
    use_bias, and groups == 1 (a grouped conv partitions the input
    channels, which a concatenation along channel-out would scramble).
    """
    by_key: Dict[Tuple, List] = {}
    for op in model.ops:
        if getattr(op, "op_type", None) != "conv2d" or op.groups != 1:
            continue
        key = (op.inputs[0].uid, op.kernel, op.stride, op.padding,
               op.activation, op.use_bias)
        by_key.setdefault(key, []).append(op)
    return [g for g in by_key.values() if len(g) > 1]
