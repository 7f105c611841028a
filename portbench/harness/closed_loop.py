"""Closed-loop serving traffic from a mix file.

A closed loop of ``clients`` clients: each sends one request, waits for
its last token, and sends its next at once. Its requests come from a
pool whose lengths, and their order, are fixed by the mix
(``sizes_seed``); ``--seed`` decides only the token ids (and the
weights). With no end-of-sequence token and nothing for the prefix
cache to share, the scheduler's plan depends on the lengths alone, so
every seed runs the same steps with the same lanes: the seed changes
the values, never the work. Lengths are clipped Pareto draws (the frozen
generator's ``_heavy``): ``min - 1 + v`` with ``v`` a Pareto draw
clipped to ``[1, max - min + 1]``, its scale set so that the lengths'
median is the mix's ``median``. Prompts are distinct
random ids in ``[1, vocab)``, so the prefix cache finds nothing to
share. Every request is greedy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .traffic import _heavy


def _lengths(rng, spec: dict, a: float, n: int) -> List[int]:
    lo, hi = int(spec["min"]), int(spec["max"])
    # the unclipped length's median is lo + scale * (2**(1/a) - 1), and
    # the clipped one's while under half of the draws clip
    scale = (float(spec["median"]) - lo) / (2.0 ** (1.0 / a) - 1.0)
    # _heavy's scale is mean * (a - 1)
    m = scale / (a - 1.0)
    return [lo - 1 + _heavy(rng, m, a, 1, hi - lo + 1) for _ in range(n)]


class RequestPool:
    """The mix's requests with this seed's token ids; :meth:`take`
    hands out the next one."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        n = int(mix["pool"])
        a = float(mix.get("pareto_a", 2.0))
        srng = np.random.default_rng([int(mix["sizes_seed"]), 0x51E5])
        prompts = _lengths(srng, mix["prompt"], a, n)
        outputs = _lengths(srng, mix["output"], a, n)
        self.sizes = list(zip(prompts, outputs))
        self.seed = int(seed) & (2 ** 64 - 1)
        self.vocab = int(vocab)
        self.taken = 0

    def take(self) -> Tuple[List[int], int]:
        """(prompt ids, output tokens) of the next request."""
        if self.taken >= len(self.sizes):
            raise RuntimeError(
                f"the mix's pool of {len(self.sizes)} requests ran out: "
                f"raise its \"pool\"")
        plen, out = self.sizes[self.taken]
        rng = np.random.default_rng([self.seed, 0x7A11, self.taken])
        self.taken += 1
        return rng.integers(1, self.vocab, size=plen).tolist(), out
