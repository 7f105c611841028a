"""Frozen copy of ``_heavy`` from ``flexflow_tpu_torch/serve/traffic.py``.

The benchmark keeps its own copy of the one function of the program's
traffic generator that it uses, the clipped-Pareto length draw, so that
a later change to the program's generator cannot move the yardstick.
The function below is the original, unchanged. ``harness/closed_loop.py``
draws every length with it.
"""

from __future__ import annotations


def _heavy(rng, mean: float, a: float, lo: int, hi: int) -> int:
    """Clipped-Pareto draw with approximate mean ``mean``: Pareto(a)
    has mean 1/(a-1) (for a > 1), so scale accordingly — the standard
    heavy-tail generator for lengths (a few giants among many small
    draws)."""
    scale = mean * (a - 1.0) if a > 1.0 else mean
    v = 1.0 + rng.pareto(a) * scale
    return int(min(hi, max(lo, round(v))))
