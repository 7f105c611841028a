"""Fusion groups and sibling-conv grouping; counterpart of
``flexflow_tpu/core/fusion.py``.

``compute_fusion_groups`` partitions the op graph into same-strategy
chains (the reference FusedOp's "same ParallelConfig, contiguous"
rule): the strategy simulator costs each chain as one task
(``perform_fusion``). In the JAX executor a group's payoff is sharding
pins at its boundaries only (``boundary_ops``); on one device there is
nothing to pin, so the port's executor runs the same ops either way.

``conv_sibling_groups`` finds the convs that read one tensor with one
geometry (Inception's 1x1 branch heads), which the executor runs as one
conv (``sibling_conv_fusion``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..parallel.pconfig import Strategy


def _strategy_key(strategy: Strategy, op_name: str) -> Tuple:
    s = strategy.for_op(op_name)
    return tuple(sorted((k, str(v)) for k, v in s.axis_map.items()))


def compute_fusion_groups(model, strategy: Optional[Strategy]
                          ) -> List[List[str]]:
    """Partition model.ops (topological order) into same-strategy chains.

    A group is a chain: op B joins producer A's group iff A and B
    resolve to the same axis map, A has exactly one in-graph consumer,
    and B has exactly one in-graph producer. Returns a list of groups,
    each a list of op names in execution order; singleton groups are
    included so the result is a partition."""
    from ..search.simulator import op_edges  # canonical edge derivation

    strategy = strategy or Strategy()
    producer, edges = op_edges(model)
    n_consumers: Dict[str, int] = {}
    for src, _dst in edges:
        n_consumers[src.name] = n_consumers.get(src.name, 0) + 1

    group_of: Dict[str, int] = {}
    groups: List[List[str]] = []
    for op in model.ops:
        in_producers = {producer[t.uid].name
                        for t in op.inputs if t.uid in producer}
        join = None
        if len(in_producers) == 1:
            (pname,) = in_producers
            if (n_consumers.get(pname, 0) == 1
                    and _strategy_key(strategy, pname)
                    == _strategy_key(strategy, op.name)):
                join = group_of[pname]
        if join is None:
            group_of[op.name] = len(groups)
            groups.append([op.name])
        else:
            group_of[op.name] = join
            groups[join].append(op.name)
    return groups


def boundary_ops(groups: List[List[str]]) -> set:
    """Names of ops that end a fused group (where sharding is pinned)."""
    return {g[-1] for g in groups}


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
