"""SLO traffic harness (``flexflow_tpu/serve/traffic.py``, copied:
numpy only, so the same spec gives the same stream in both packages).

Offline throughput numbers say little about "millions of users": what
decides whether a serving tier holds is how it behaves under a TIMED
arrival stream — bursts, heavy-tailed prompt/output lengths, many
tenants sharing system preambles, users hitting stop mid-generation.
This module synthesizes exactly that traffic, seeded and fully
deterministic, so goodput-under-SLO (requests meeting both the TTFT
and TPOT targets, per second — the metric the multi-replica router
A/B gates on, tools/serve_bench.py ``--workload router``) is a
reproducible number instead of a wall-clock anecdote.

Shapes generated (:func:`make_traffic` over a :class:`TrafficSpec`):

  * arrivals — Poisson (exponential inter-arrival gaps at
    ``rate_rps``) or bursty (the same Poisson process whose rate
    multiplies by ``burst_factor`` inside seeded burst windows — the
    thundering-herd pattern an autoscaler must absorb);
  * multi-tenant prefix mixes — each tenant owns a shared prompt
    prefix (the few-shot / system-preamble pattern), tenants drawn
    Zipf-skewed so a few tenants dominate exactly as production
    traffic does; a request's prompt is its tenant's prefix plus a
    unique heavy-tailed tail;
  * heavy-tailed lengths — prompt tails and output budgets draw from
    a clipped Pareto (a few giants among many small requests: the
    shape that makes p99 — not the mean — the number that matters);
  * mid-generation cancels — a seeded fraction of requests abandons
    after a heavy-tailed number of emitted tokens (the router must
    reclaim their affinity pins and pages);
  * seeded sampling — a fraction decodes with temperature/top-k
    keyed to the request's ``stream_id``, so routed/disaggregated
    token streams must reproduce a single engine's bit-for-bit
    (docs/serving.md "Sampled streams").

Everything keys off ``TrafficSpec.seed``: the same spec always yields
the same request list, which is what makes router A/Bs, autoscaler
decisions and chaos replays comparable across arms and runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

__all__ = ["TrafficRequest", "TrafficSpec", "make_traffic",
           "rescale_arrivals", "tenant_prefixes"]


@dataclasses.dataclass
class TrafficRequest:
    """One request of a synthesized stream. ``stream_id`` is its
    global identity: the router submits it as the sampling stream id
    (token streams reproduce on any replica) and keys its tracking
    record by it."""

    stream_id: int
    t_arrival: float
    tenant: int
    prompt: List[int]
    max_new: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    # abandon after this many emitted tokens (None = runs to the end)
    cancel_after_tokens: Optional[int] = None

    @property
    def sampled(self) -> bool:
        return self.temperature > 0.0


@dataclasses.dataclass
class TrafficSpec:
    """Knobs of one synthesized stream (defaults are bench-sized; the
    smoke workload shrinks them). Lengths are clipped to
    ``max_prompt`` / ``max_new_cap`` so every request is admissible
    against the serving engine's ``max_seq_len``."""

    requests: int = 64
    seed: int = 0
    # ---- arrivals ----
    arrival: str = "poisson"          # "poisson" | "bursty"
    rate_rps: float = 8.0             # mean arrival rate
    burst_factor: float = 4.0         # in-burst rate multiplier
    burst_len: int = 8                # mean requests per burst window
    # ---- tenants / prefix mix ----
    # Tenant ids double as adapter names when the engine arms a LoRA
    # pool (serve/adapters.py): tenant 0 is the base model, tenants
    # 1..N-1 must each have a registered adapter before traffic for
    # them is submitted.  The Zipf head (tenant 0) therefore exercises
    # the base path while the tail exercises pool churn.
    tenants: int = 4
    tenant_zipf: float = 1.1          # Zipf skew over tenant draw
    prefix_tokens: int = 48           # shared per-tenant prefix length
    # ---- heavy-tailed lengths (clipped Pareto) ----
    tail_mean: float = 8.0            # unique prompt tail tokens
    output_mean: float = 12.0         # decode budget per request
    pareto_a: float = 2.0             # tail index (lower = heavier)
    max_prompt: int = 96
    max_new_cap: int = 32
    # ---- behaviors ----
    cancel_frac: float = 0.0          # mid-generation abandon fraction
    sample_frac: float = 0.0          # seeded-sampling fraction
    temperature: float = 0.8
    top_k: int = 4
    vocab: int = 512

    def validate(self) -> None:
        if self.requests < 1:
            raise ValueError(f"requests must be >= 1, got "
                             f"{self.requests}")
        if self.arrival not in ("poisson", "bursty"):
            raise ValueError(f"arrival must be 'poisson' or 'bursty', "
                             f"got {self.arrival!r}")
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got "
                             f"{self.rate_rps}")
        if self.tenants < 1:
            raise ValueError(f"tenants must be >= 1, got "
                             f"{self.tenants}")
        if not 0.0 <= self.cancel_frac <= 1.0 \
                or not 0.0 <= self.sample_frac <= 1.0:
            raise ValueError("cancel_frac/sample_frac must be in "
                             "[0, 1]")
        if self.prefix_tokens >= self.max_prompt:
            raise ValueError(
                f"prefix_tokens ({self.prefix_tokens}) must leave "
                f"room for a tail under max_prompt "
                f"({self.max_prompt})")


def tenant_prefixes(spec: TrafficSpec) -> Dict[int, List[int]]:
    """The per-tenant shared prompt prefixes, derived from the spec's
    seed alone (a router test can rebuild them to pre-warm a replica
    without replaying traffic)."""
    rng = np.random.default_rng([int(spec.seed), 0x7E9A97])
    return {t: rng.integers(1, spec.vocab,
                            size=spec.prefix_tokens).tolist()
            for t in range(spec.tenants)}


def rescale_arrivals(traffic: List[TrafficRequest],
                     scale: float) -> List[TrafficRequest]:
    """A copy of the stream with every arrival time multiplied by
    ``scale`` — wall-clock pacing's rate knob (docs/serving.md
    "Wall-clock mode"): the same requests (prompts, tenants, sampling,
    cancels untouched, so token identity across arms holds) arriving
    ``1/scale`` times faster. A wall-clock bench shrinks a
    virtual-authoritative stream's timeline to something measurable
    without re-synthesizing the workload."""
    if not scale > 0.0:
        raise ValueError(f"scale must be > 0, got {scale}")
    return [dataclasses.replace(t, t_arrival=t.t_arrival * scale)
            for t in traffic]


def _heavy(rng, mean: float, a: float, lo: int, hi: int) -> int:
    """Clipped-Pareto draw with approximate mean ``mean``: Pareto(a)
    has mean 1/(a-1) (for a > 1), so scale accordingly — the standard
    heavy-tail generator for lengths (a few giants among many small
    draws)."""
    scale = mean * (a - 1.0) if a > 1.0 else mean
    v = 1.0 + rng.pareto(a) * scale
    return int(min(hi, max(lo, round(v))))


def make_traffic(spec: TrafficSpec) -> List[TrafficRequest]:
    """Synthesize the stream: a pure, deterministic function of the
    spec (same spec -> byte-identical requests). Returned sorted by
    arrival time with ``stream_id`` in arrival order."""
    spec.validate()
    rng = np.random.default_rng([int(spec.seed), 0x5EEDED])
    prefixes = tenant_prefixes(spec)
    # Zipf-skewed tenant weights: w_t ~ 1/(t+1)^s, normalized
    w = np.array([1.0 / (t + 1) ** spec.tenant_zipf
                  for t in range(spec.tenants)])
    w /= w.sum()

    # arrival clock: exponential gaps at rate_rps; in bursty mode the
    # stream alternates seeded windows of ~burst_len requests between
    # the base rate and burst_factor x it (mean rate stays comparable,
    # the VARIANCE is the point)
    t = 0.0
    in_burst = False
    window_left = 0
    out: List[TrafficRequest] = []
    for i in range(spec.requests):
        rate = spec.rate_rps
        if spec.arrival == "bursty":
            if window_left <= 0:
                in_burst = not in_burst
                window_left = max(1, int(rng.poisson(spec.burst_len)))
            window_left -= 1
            if in_burst:
                rate = spec.rate_rps * spec.burst_factor
            else:
                rate = spec.rate_rps / max(1.0, spec.burst_factor / 2)
        t += float(rng.exponential(1.0 / rate))
        tenant = int(rng.choice(spec.tenants, p=w))
        tail_cap = spec.max_prompt - spec.prefix_tokens
        tail = _heavy(rng, spec.tail_mean, spec.pareto_a, 1, tail_cap)
        prompt = prefixes[tenant] + rng.integers(
            1, spec.vocab, size=tail).tolist()
        max_new = _heavy(rng, spec.output_mean, spec.pareto_a, 1,
                         spec.max_new_cap)
        temperature, top_k = 0.0, None
        if spec.sample_frac and rng.random() < spec.sample_frac:
            temperature, top_k = spec.temperature, spec.top_k
        cancel = None
        if spec.cancel_frac and rng.random() < spec.cancel_frac \
                and max_new > 1:
            cancel = _heavy(rng, max(1.0, max_new / 3), spec.pareto_a,
                            1, max_new - 1)
        out.append(TrafficRequest(
            stream_id=i, t_arrival=t, tenant=tenant, prompt=prompt,
            max_new=max_new, temperature=temperature, top_k=top_k,
            cancel_after_tokens=cancel))
    return out
