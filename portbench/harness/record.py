"""What a run records, for the metric readers (``metrics/*.py``).

The cell drivers fill a :class:`Run`; each reader takes what it needs
from it and returns a number, or None where the run has nothing for it
to read. Times are ``time.perf_counter`` seconds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from . import peaks as _peaks
from . import work as _work


@dataclasses.dataclass
class Step:
    """One serving step as the benchmark saw it: the host clock around
    ``ServeSession.step`` and its plan's lanes."""

    t0: float
    t1: float
    lanes: int            # lanes computed (prefill and decode)
    lens_sum: int         # visible lengths of those lanes, summed
    live_pages: int       # pages their requests read (kernel 1)
    emitted: int          # tokens handed to clients
    in_window: bool = False
    traced: bool = False


@dataclasses.dataclass
class Request:
    """One request as its client saw it."""

    t_send: float
    prompt: List[int]
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    t_done: Optional[float] = None
    n_out: int = 0
    outcome: Optional[str] = None
    tokens: Optional[List[int]] = None


@dataclasses.dataclass
class FitCall:
    """One ``FFModel.fit`` call of the training window."""

    t0: float
    t1: float
    steps: int
    gap_s_mean: float     # fit's own dispatch_gap_s_mean
    traced: bool = False


class Run:
    """One run of one cell."""

    peaks = _peaks.H100
    work = _work

    def __init__(self, cell: str, workload: dict, config: dict, mix: dict):
        self.cell = cell
        self.workload = workload
        self.config = config
        self.mix = mix
        self.kind = config["kind"]
        self.setup_s: Optional[float] = None
        self.w0: Optional[float] = None
        self.w1: Optional[float] = None
        self.steps: List[Step] = []
        self.requests: List[Request] = []
        self.fit_calls: List[FitCall] = []
        self.mixed_width = 0
        self.batch = 0
        self.seq = 0
        self.trace = None          # trace.Reduced of a traced run
        self.checks: Dict[str, dict] = {}
        self.info: Dict[str, object] = {}
        self.attempted = 0
        self.failed = 0

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def window_steps(self) -> List[Step]:
        return [s for s in self.steps if s.in_window]

    def traced_steps(self) -> List[Step]:
        return [s for s in self.steps if s.traced]

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.w0 <= t <= self.w1
