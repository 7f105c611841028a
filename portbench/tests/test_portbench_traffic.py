"""The traffic: one seed, one stream; every seed, the same sizes."""

import json
import statistics
from collections import Counter
from pathlib import Path

import numpy as np

from flexflow_tpu_torch.serve import traffic as program_traffic
from portbench.harness import traffic
from portbench.harness.closed_loop import RequestPool

MIXES = Path(__file__).resolve().parent.parent / "traffic"


def _drain(pool, n):
    return [pool.take() for _ in range(n)]


def test_same_seed_same_requests():
    mix = json.loads((MIXES / "azure-conversation.json").read_text())
    a = _drain(RequestPool(mix, 2 ** 31 + 11, 50272), 50)
    b = _drain(RequestPool(mix, 2 ** 31 + 11, 50272), 50)
    assert a == b
    c = _drain(RequestPool(mix, 2 ** 31 + 12, 50272), 50)
    assert a != c


def test_every_seed_the_same_sizes_in_the_same_order():
    mix = json.loads((MIXES / "azure-conversation.json").read_text())
    p1, p2 = RequestPool(mix, 5, 50272), RequestPool(mix, 6, 50272)
    assert p1.sizes == p2.sizes
    assert len(Counter(p1.sizes)) > len(p1.sizes) // 4
    lo_p, hi_p = mix["prompt"]["min"], mix["prompt"]["max"]
    lo_o, hi_o = mix["output"]["min"], mix["output"]["max"]
    assert all(lo_p <= p <= hi_p and lo_o <= o <= hi_o for p, o in p1.sizes)
    assert all(p + o <= 2048 for p, o in p1.sizes)


def test_the_mix_keeps_the_traces_medians():
    """The lengths' medians are the published trace's within the
    sample's own scatter."""
    mix = json.loads((MIXES / "azure-conversation.json").read_text())
    sizes = RequestPool(mix, 5, 50272).sizes
    for i, key in enumerate(("prompt", "output")):
        got = statistics.median(sz[i] for sz in sizes)
        want = mix[key]["median"]
        assert abs(got - want) < 0.06 * want, (key, got, want)


def test_another_mix_keeps_its_medians_and_bounds():
    mix = {"pool": 4096, "sizes_seed": 3, "pareto_a": 3.0,
           "prompt": {"min": 64, "max": 512, "median": 160},
           "output": {"min": 32, "max": 256, "median": 80}}
    sizes = RequestPool(mix, 5, 50272).sizes
    for i, key in enumerate(("prompt", "output")):
        got = [sz[i] for sz in sizes]
        assert abs(statistics.median(got) - mix[key]["median"]) \
            < 0.06 * mix[key]["median"]
        assert mix[key]["min"] <= min(got) and max(got) <= mix[key]["max"]


def test_prompts_are_distinct_ids_in_range():
    mix = json.loads((MIXES / "azure-conversation.json").read_text())
    pool = RequestPool(mix, 3, 50272)
    reqs = _drain(pool, 40)
    assert all(1 <= t < 50272 for p, _ in reqs for t in p)
    assert len({tuple(p[:16]) for p, _ in reqs}) == 40


def test_frozen_draw_is_the_programs():
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    for mean, lo, hi in ((200.0, 1, 449), (96.0, 1, 225), (5.0, 2, 9)):
        for _ in range(200):
            assert traffic._heavy(a, mean, 2.0, lo, hi) == \
                program_traffic._heavy(b, mean, 2.0, lo, hi)
