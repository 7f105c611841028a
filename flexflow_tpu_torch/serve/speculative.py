"""Host-side drafting for speculative decoding.

A copy of ``flexflow_tpu/serve/speculative.py``: the port keeps its own
so it never imports the JAX package.

Speculative decoding spends SPARE LANES of the fixed-shape mixed step
(serve/engine.py) to advance a decoding sequence by more than one token
per program dispatch: a cheap DRAFTER proposes k continuation tokens,
the engine scores positions [n-1, n-1+k] in one step (each lane's
logits are exactly the logits the reference would compute at that
position GIVEN the drafts before it), and the host accepts the longest
prefix of drafts that match what the model would have emitted anyway.
Greedy verification is therefore token-IDENTICAL to one-at-a-time
decode — a mis-draft costs lanes, never correctness — which is what
lets the serving exactness gate (outputs == generate_reference) keep
running unchanged over the speculative path.

Two pieces live here, both pure host Python:

  * :class:`PromptLookupDrafter` — prompt-lookup / n-gram drafting: the
    proposal for "what comes after the current suffix" is "whatever
    followed the most recent earlier occurrence of that suffix" in the
    sequence's OWN token history (prompt + generated). No second model,
    no device work, so it drafts (and benches) on CPU CI; repetitive
    text — code, few-shot scaffolding, retrieval quotes — accepts
    nearly everything, adversarial text simply finds no match. The
    :class:`Drafter` interface is one method, so a small draft LM can
    slot in later without touching the scheduler.
  * :class:`DraftControl` — per-request adaptive draft length: a
    windowed acceptance rate scales k between 0 and the configured
    maximum (serve_spec_tokens). Text that keeps rejecting drafts
    drives k to 0 (speculation auto-disables: the request degrades to
    exactly the non-speculative engine, paying nothing), with a rare
    1-token probe so a request whose text turns repetitive later can
    re-enable itself.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Deque, List, Sequence, Tuple


class Drafter:
    """Interface: propose up to k likely continuation tokens for a
    sequence whose resident context is `tokens`. Fewer (or zero)
    proposals are always legal — the scheduler drafts what it gets —
    and wrong proposals are always safe (verification rejects them)."""

    def draft(self, tokens: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError


class PromptLookupDrafter(Drafter):
    """Prompt-lookup decoding: match the context's trailing n-gram
    against its own earlier history and propose the tokens that
    followed the MOST RECENT earlier occurrence.

    Longer n-grams are tried first (a 3-gram match is far more
    predictive than a 1-gram match). Among a length's matches, the most
    recent occurrence that can supply all k continuation tokens wins —
    recency matters because generated text drifts, but an occurrence
    too close to the tail clips its continuation at the end of known
    history (on a constant run the nearest match yields ONE token while
    an earlier one yields k), so fullness outranks pure recency; with
    no full continuation anywhere, the longest available one is taken.
    The scan is O(len * max_ngram) per draft over plain Python ints,
    i.e. microseconds at serving context lengths — the whole point is
    that drafting must cost less than the lanes it risks."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def draft(self, tokens: Sequence[int], k: int) -> List[int]:
        if k <= 0:
            return []
        tokens = list(tokens)
        n_tok = len(tokens)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if n_tok <= n:
                continue
            pattern = tokens[-n:]
            first = pattern[0]
            rest = pattern[1:]
            best: List[int] = []
            # right-to-left: most recent first; stop at the first match
            # whose continuation is full (earlier matches only ever
            # offer MORE continuation, never more recency). The
            # first-element filter keeps the hot loop allocation-free —
            # this scan runs per decoding sequence per step on the host.
            for i in range(n_tok - n - 1, -1, -1):
                if tokens[i] != first:
                    continue
                if rest and tokens[i + 1:i + n] != rest:
                    continue
                avail = min(k, n_tok - i - n)
                if avail > len(best):
                    best = tokens[i + n:i + n + avail]
                    if avail == k:
                        break
            if best:
                return best
        return []


class DraftControl:
    """Per-request draft-length controller over a windowed acceptance
    rate.

    Each verified step records (drafted, accepted); `next_k` maps the
    rate over the last `window` drafting steps to a length in
    [0, k_max]:

      * no history yet  -> k_max (optimism is free: the first window
        measures the text, and wrong drafts only waste budget lanes)
      * rate >= disable_below, or window not yet full -> ceil(k_max *
        3/2 * rate), clamped to [1, k_max]: floored at 1 so the
        estimate keeps refreshing, and overshooting on mid rates
        because a draft's cost (a budget lane) is far below its payoff
        (a whole saved step) — k should only shrink when drafts are
        mostly dead weight
      * a FULL window below `disable_below` -> 0: the text is
        adversarial for this drafter, and a 0-draft request is
        bit-for-bit the plain decode path. Every `probe_every`-th
        decode step the stale window is DROPPED and a single token is
        drafted — a fresh measurement, so a sequence whose text turns
        repetitive later (e.g. enters a generation loop) climbs back
        out of 0 in a handful of steps instead of dragging a window
        full of old failures behind it. A failed probe refills the
        window with cheap 1-token drafts and re-disables.

    All decisions are deterministic functions of the request's own
    history — no RNG, so serving stays reproducible."""

    def __init__(self, k_max: int, window: int = 8,
                 disable_below: float = 0.125, probe_every: int = 32):
        self.k_max = int(k_max)
        self.window = int(window)
        self.disable_below = float(disable_below)
        self.probe_every = int(probe_every)
        self._hist: Deque[Tuple[int, int]] = deque(maxlen=self.window)
        self._decode_steps = 0
        # a probe cleared the window and its measurement has not come
        # back yet: stay at 1-token drafts, NOT the fresh-request
        # optimism (the text already measured adversarial once)
        self._probing = False
        # lifetime counters (serve_report / tests)
        self.drafted = 0
        self.accepted = 0

    @property
    def rate(self) -> float:
        d = sum(d for d, _ in self._hist)
        return sum(a for _, a in self._hist) / d if d else 1.0

    @property
    def disabled(self) -> bool:
        """True when the windowed rate has auto-disabled drafting."""
        return (len(self._hist) == self.window
                and self.rate < self.disable_below)

    def next_k(self) -> int:
        """Draft length for this decode step (before budget/page/
        length clamps — the scheduler shrinks, never grows)."""
        self._decode_steps += 1
        if self.k_max <= 0:
            return 0
        if not self._hist:
            # empty history is optimism only BEFORE the first
            # measurement; after a probe cleared the window (and the
            # drafter may have had nothing to propose, recording
            # nothing) it must stay a 1-token re-measure, or
            # adversarial text would re-trigger full-width drafting
            # every probe period
            return 1 if self._probing else self.k_max
        if self.disabled:
            if self.probe_every and \
                    self._decode_steps % self.probe_every == 0:
                self._hist.clear()   # fresh measurement, not an average
                self._probing = True
                return 1
            return 0
        return max(1, min(self.k_max,
                          int(math.ceil(self.k_max * 1.5 * self.rate))))

    def record(self, drafted: int, accepted: int) -> None:
        """Outcome of one verified step. Steps that drafted nothing
        (no n-gram match, no budget) carry no signal about the text
        and are not recorded."""
        if drafted <= 0:
            return
        assert 0 <= accepted <= drafted, (drafted, accepted)
        self._hist.append((drafted, accepted))
        self._probing = False
        self.drafted += drafted
        self.accepted += accepted
