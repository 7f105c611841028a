"""Memory accounting of the placement explainer
(``flexflow_tpu/search/explain.py``): only :func:`pytree_device_bytes`,
which the serving ledgers read (``ServeEngine.memory_ledger``,
``DisaggCluster.memory_ledger``). The per-op explanation of the
training search comes with its port (ROADMAP module item 5)."""

from __future__ import annotations

__all__ = ["pytree_device_bytes"]


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def pytree_device_bytes(tree) -> float:
    """Resident bytes of the live tensors in `tree` (nested dicts, lists
    and tuples; None and non-tensor leaves count nothing): what occupies
    the card's memory. One device holds every tensor whole — the port
    shards nothing yet."""
    return float(sum(x.nbytes for x in _leaves(tree)
                     if hasattr(x, "nbytes")))
