"""Search tracing (``flexflow_tpu/search/trace.py``, whole): per-proposal
events and convergence diagnostics of one placement walk.

A :class:`SearchTrace` rides one optimize_serve / optimize_serve_mesh
call, recording every proposal (iteration, chain, the move, delta-cost,
accept/reject, the Metropolis temperature, the pricing path) into a
bounded per-chain ring, plus each chain's best-cost curve. Tracing is
pure host-side observation: a traced search is bit-identical to an
untraced one at the same seed (recording never touches the RNG), the
rings are bounded, and ``summary()`` is deterministic (chains merge by
(iteration, chain), never by thread interleaving).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

__all__ = ["SearchTrace"]

# event tuple layout (a tuple append on the hot path): (iteration,
# chain, kind, ops, delta_cost, accepted, temperature, path)


class _ChainStats:
    """One chain's accounting — touched by exactly one thread."""

    __slots__ = ("events", "dropped", "proposals", "accepts",
                 "by_path", "by_phase", "curve", "best")

    def __init__(self, max_events: int, phases: int):
        self.events: deque = deque(maxlen=max_events)
        self.dropped = 0
        self.proposals = 0
        self.accepts = 0
        self.by_path: Dict[str, List[int]] = {}
        self.by_phase = [[0, 0] for _ in range(phases)]
        self.curve: List[tuple] = []   # (iteration, cost) improvements
        self.best = float("inf")


class SearchTrace:
    """Bounded per-proposal event rings for one search run.

    One instance is shared by every chain of the run; each chain's
    events/counters live in its own :class:`_ChainStats` (created via
    the GIL-atomic ``dict.setdefault``), so parallel chains never race
    and the summary is reproducible. Phases for the
    acceptance-by-phase diagnostic are thirds of the per-chain budget —
    the standard annealing burn-in / search / refine split."""

    MAX_EVENTS = 65536
    PHASES = 3
    CURVE_TAIL = 32

    def __init__(self, budget: int = 0, chains: int = 1,
                 max_events: Optional[int] = None):
        self.budget = max(1, int(budget))
        self.max_events_per_chain = max(
            1, int(max_events or self.MAX_EVENTS) // max(1, int(chains)))
        self._chains: Dict[int, _ChainStats] = {}

    def _chain(self, chain: int) -> _ChainStats:
        st = self._chains.get(chain)
        if st is None:
            st = self._chains.setdefault(
                chain, _ChainStats(self.max_events_per_chain,
                                   self.PHASES))
        return st

    # ------------- recording (hot path: one append) --------------------
    def record(self, iteration: int, chain: int, kind: str, ops,
               delta_cost: float, accepted: bool, temperature: float,
               path: str) -> None:
        """One proposal. ``kind`` is the move type (rewrite / propagate
        / staged / serve_place), ``ops`` the op name(s) the move
        touched, ``path`` "delta" when Simulator.simulate_delta priced
        it, "full" for a full event-loop simulation."""
        st = self._chain(chain)
        if len(st.events) == st.events.maxlen:
            st.dropped += 1
        st.events.append((iteration, chain, kind, ops, delta_cost,
                          accepted, temperature, path))
        st.proposals += 1
        p = st.by_path.setdefault(path, [0, 0])
        p[0] += 1
        phase = min(self.PHASES - 1,
                    max(0, iteration) * self.PHASES // self.budget)
        st.by_phase[phase][0] += 1
        if accepted:
            st.accepts += 1
            p[1] += 1
            st.by_phase[phase][1] += 1

    def record_best(self, iteration: int, chain: int,
                    cost: float) -> None:
        """A new chain-best simulated cost (the convergence curve; the
        run-wide curve is merged deterministically in summary())."""
        st = self._chain(chain)
        if cost < st.best:
            st.best = cost
            st.curve.append((int(iteration), float(cost)))

    # ------------- diagnostics -----------------------------------------
    def summary(self, curve_tail: Optional[int] = None) -> dict:
        """The machine-readable convergence diagnostics search_report
        renders and BENCH_search.json records: acceptance rate overall
        / by phase / by simulation path, the run-wide best-cost-curve
        tail (chain curves merged by (iteration, chain) — thread-
        interleaving cannot change it), and the ring accounting."""
        chains = [self._chains[k] for k in sorted(self._chains)]
        proposals = sum(c.proposals for c in chains)
        accepts = sum(c.accepts for c in chains)
        by_phase = [[0, 0] for _ in range(self.PHASES)]
        by_path: Dict[str, List[int]] = {}
        for c in chains:
            for i, (p, a) in enumerate(c.by_phase):
                by_phase[i][0] += p
                by_phase[i][1] += a
            for path, (p, a) in c.by_path.items():
                t = by_path.setdefault(path, [0, 0])
                t[0] += p
                t[1] += a
        # run-wide best-cost curve: all chain improvements ordered by
        # (iteration, chain id), filtered to running improvements
        entries = sorted(
            (it, k, cost)
            for k in sorted(self._chains)
            for it, cost in self._chains[k].curve)
        curve = []
        best = float("inf")
        for it, k, cost in entries:
            if cost < best:
                best = cost
                curve.append({"iteration": it, "chain": k,
                              "cost_s": cost})
        tail = int(curve_tail or self.CURVE_TAIL)
        return {
            "proposals": proposals,
            "accepts": accepts,
            "acceptance_rate": accepts / proposals if proposals else 0.0,
            "acceptance_by_phase": [
                {"proposals": p, "accepts": a,
                 "rate": a / p if p else 0.0}
                for p, a in by_phase],
            "by_path": {
                path: {"proposals": p, "accepts": a}
                for path, (p, a) in sorted(by_path.items())},
            "best_cost_curve": curve[-tail:],
            "best_cost_s": curve[-1]["cost_s"] if curve else None,
            "improvements": len(curve),
            "events_recorded": sum(len(c.events) for c in chains),
            "events_dropped": sum(c.dropped for c in chains),
        }

    def events_list(self) -> List[dict]:
        """The retained rings as dicts, ordered by (chain, iteration)
        (debug and notebook use)."""
        keys = ("iteration", "chain", "kind", "ops", "delta_cost",
                "accepted", "temperature", "path")
        return [dict(zip(keys, e))
                for k in sorted(self._chains)
                for e in list(self._chains[k].events)]
