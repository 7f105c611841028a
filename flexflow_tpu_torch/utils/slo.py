"""SLO burn-rate monitoring over exported metrics.

A copy of ``flexflow_tpu/utils/slo.py`` (pure host Python), kept in the
port so it never imports the JAX package. :class:`SLOBurnMonitor` reads
the error-budget counters ``serve_slo_requests_total`` and
``serve_slo_violations_total`` from a :class:`MetricsRegistry` at each
tick of a caller's clock, computes the error rate over a FAST and a
SLOW window, each divided by the error budget into a burn rate, FIRES
an alert when both windows burn past their thresholds and CLEARS it
when both drop back under. Every transition lands in
``monitor.events`` (replayable at one seed) and, with a telemetry bus,
as ``slo_alert_fire`` / ``slo_alert_clear`` instants and one
``slo_alert`` span per episode on the ``(serve, slo)`` track; every
tick publishes ``slo_burn_rate`` and ``slo_budget_remaining`` gauges.
The replica pool that exports those counters and arms the monitor is
not ported yet.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .telemetry import MetricsRegistry, Telemetry

__all__ = ["SLOBurnMonitor"]

_SLO_TRACK = ("serve", "slo")

# violation labels the pool exports (serve/router.py _finalize):
# which SLO bound a violating request burned
SLO_DIMS = ("ttft", "tpot", "outcome")


class SLOBurnMonitor:
    """Multi-window error-budget burn-rate monitor.

    ``error_budget`` is the tolerated violation fraction (0.01 = a
    99% SLO). ``fast_burn`` / ``slow_burn`` default to the SRE-workbook
    page thresholds (14.4x / 6x — budget gone in ~2 days / ~5 days at
    a 30-day period); both windows must burn past threshold for the
    alert to fire, and both must recover for it to clear. All times
    are whatever clock the caller ticks ``observe`` on — the
    ReplicaPool uses its deterministic virtual clock, a wall-clock
    deployment would tick wall seconds; the monitor never reads a
    clock itself (except to stamp telemetry span walls), which is what
    keeps replays exact."""

    def __init__(self, registry: MetricsRegistry, *,
                 error_budget: float = 0.01,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 fast_burn: float = 14.4,
                 slow_burn: float = 6.0,
                 interval_s: float = 60.0,
                 telemetry: Optional[Telemetry] = None,
                 slo: Optional[dict] = None):
        if not (0.0 < error_budget <= 1.0):
            raise ValueError(
                f"error_budget must be in (0, 1], got {error_budget}")
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError(
                f"need 0 < fast_window_s <= slow_window_s, got "
                f"{fast_window_s}/{slow_window_s}")
        if fast_burn <= 0 or slow_burn <= 0:
            raise ValueError(
                f"burn thresholds must be > 0, got "
                f"{fast_burn}/{slow_burn}")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.error_budget = float(error_budget)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.interval_s = float(interval_s)
        self.telemetry = telemetry
        self.slo = dict(slo or {})
        # counter-history samples: (t, total, viol, {dim: viol_dim}).
        # Bounded: everything strictly older than the slow window is
        # pruned (one pre-window sample survives as the baseline).
        self._samples: deque = deque()
        self.state = "ok"
        self.episodes = 0
        self._fire_wall: Optional[float] = None
        self._fire_t: Optional[float] = None
        self.events: List[dict] = []

    @classmethod
    def from_config(cls, config, registry: MetricsRegistry,
                    **kw) -> "SLOBurnMonitor":
        """Budget from FFConfig.slo_error_budget, SLO targets from the
        --slo-ttft-ms/--slo-tpot-ms flags (for the report header)."""
        kw.setdefault("error_budget",
                      float(getattr(config, "slo_error_budget", 0.01)))
        kw.setdefault("slo", {
            "ttft_s": float(getattr(config, "slo_ttft_ms", 0.0)) / 1e3,
            "tpot_s": float(getattr(config, "slo_tpot_ms", 0.0)) / 1e3})
        return cls(registry, **kw)

    # ---------------- the windowed burn math ---------------------------
    def _read(self) -> Tuple[float, float, Dict[str, float]]:
        m = self.registry
        return (m.counter("serve_slo_requests_total"),
                m.counter("serve_slo_violations_total"),
                {d: m.counter("serve_slo_violations_total", slo=d)
                 for d in SLO_DIMS})

    def _baseline(self, t_now: float, window_s: float):
        """Latest sample at or before the window start (the FIRST
        sample when history is shorter than the window — the burn then
        covers all available history, the conservative read)."""
        base = self._samples[0]
        for s in self._samples:
            if s[0] <= t_now - window_s:
                base = s
            else:
                break
        return base

    def _burn(self, t_now: float, window_s: float,
              dim: Optional[str] = None) -> float:
        """Windowed violation fraction over the error budget. No
        requests in the window = burn 0 (an idle tier spends no
        budget)."""
        now = self._samples[-1]
        base = self._baseline(t_now, window_s)
        total = now[1] - base[1]
        if total <= 0:
            return 0.0
        if dim is None:
            viol = now[2] - base[2]
        else:
            viol = now[3][dim] - base[3][dim]
        return (viol / total) / self.error_budget

    # ---------------- the control tick ----------------------------------
    def observe(self, t_now: float) -> Optional[dict]:
        """One tick: sample the exported counters, publish the burn
        gauges, and fire/clear the alert. Returns the transition event
        when one happened (also appended to ``events``), else None."""
        t_now = float(t_now)
        total, viol, dims = self._read()
        self._samples.append((t_now, total, viol, dims))
        # prune past the slow window, keeping one baseline sample
        while len(self._samples) >= 2 \
                and self._samples[1][0] <= t_now - self.slow_window_s:
            self._samples.popleft()
        fast = self._burn(t_now, self.fast_window_s)
        slow = self._burn(t_now, self.slow_window_s)
        remaining = (1.0 - viol / (self.error_budget * total)
                     if total > 0 else 1.0)
        m = self.registry
        m.set("slo_burn_rate", fast, window="fast")
        m.set("slo_burn_rate", slow, window="slow")
        for d in SLO_DIMS:
            m.set("slo_burn_rate", self._burn(t_now, self.fast_window_s,
                                              d),
                  window="fast", slo=d)
        m.set("slo_budget_remaining", remaining)
        m.set("slo_error_budget", self.error_budget)
        m.set("slo_alert_firing", 1.0 if self.state == "firing" else 0.0)
        firing = fast >= self.fast_burn and slow >= self.slow_burn
        event = None
        if firing and self.state == "ok":
            self.state = "firing"
            self.episodes += 1
            self._fire_t = t_now
            self._fire_wall = time.perf_counter()
            event = {"t": t_now, "state": "firing",
                     "episode": self.episodes, "burn_fast": fast,
                     "burn_slow": slow, "budget_remaining": remaining}
            if self.telemetry is not None and self.telemetry.enabled:
                self.telemetry.instant(
                    _SLO_TRACK, "slo_alert_fire",
                    args={k: v for k, v in event.items()})
            m.inc("slo_alerts_total", direction="fire")
            m.set("slo_alert_firing", 1.0)
        elif not firing and self.state == "firing":
            self.state = "ok"
            event = {"t": t_now, "state": "ok",
                     "episode": self.episodes, "burn_fast": fast,
                     "burn_slow": slow, "budget_remaining": remaining}
            self._close_episode(t_now, event)
            m.inc("slo_alerts_total", direction="clear")
            m.set("slo_alert_firing", 0.0)
        if event is not None:
            self.events.append(event)
        return event

    def _close_episode(self, t_now: float, event: dict) -> None:
        """Emit the episode's telemetry: a clear instant plus ONE
        complete ``slo_alert`` span covering the episode's WALL
        interval (the trace clock is wall time; the virtual fire/clear
        times ride in args, the autoscaler-span convention)."""
        tel = self.telemetry
        if tel is not None and tel.enabled \
                and self._fire_wall is not None:
            now_wall = time.perf_counter()
            tel.instant(_SLO_TRACK, "slo_alert_clear",
                        args={k: v for k, v in event.items()})
            tel.span(_SLO_TRACK, "slo_alert", self._fire_wall,
                     now_wall,
                     args={"episode": self.episodes,
                           "t_fire": self._fire_t, "t_clear": t_now})
        self._fire_wall = None
        self._fire_t = None

    def finish(self, t_now: float) -> None:
        """Close a still-burning episode's SPAN at drain (the alert
        state itself does not transition — the tier ended the run in
        violation, and the events list says so honestly)."""
        if self.state == "firing":
            self._close_episode(
                float(t_now),
                {"t": float(t_now), "state": "end_firing",
                 "episode": self.episodes})

    # ---------------- reporting -----------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready monitor state for tools/slo_report.py: config,
        current burn gauges, alert state and the transition history."""
        m = self.registry
        return {
            "error_budget": self.error_budget,
            "slo": dict(self.slo),
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "fast_burn_threshold": self.fast_burn,
            "slow_burn_threshold": self.slow_burn,
            "interval_s": self.interval_s,
            "state": self.state,
            "episodes": self.episodes,
            "burn_fast": m.gauge("slo_burn_rate", window="fast"),
            "burn_slow": m.gauge("slo_burn_rate", window="slow"),
            "budget_remaining": m.gauge("slo_budget_remaining", 1.0),
            "requests": m.counter("serve_slo_requests_total"),
            "violations": m.counter("serve_slo_violations_total"),
            "violations_by_slo": {
                d: m.counter("serve_slo_violations_total", slo=d)
                for d in SLO_DIMS},
            "events": list(self.events),
        }
