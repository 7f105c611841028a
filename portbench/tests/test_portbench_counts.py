"""The yardstick's counts against shapes worked by hand."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import work

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def test_flash_work_by_hand():
    # b=1, s=4, h=1, d=2, bf16, causal: 4*5/2 = 10 (query, key) pairs
    got = work.flash_work(1, 4, 4, 1, 2, 2, True)
    # operands 1*4*1*2*2 = 16 bytes each, lse/delta rows 1*1*4*4 = 16
    assert got["flash_fwd"] == (2 * 16 + 2 * 16 + 16, 4 * 2 * 10)
    assert got["flash_bwd_dq"] == (3 * 16 + 2 * 16 + 2 * 16, 6 * 2 * 10)
    assert got["flash_bwd_dkv"] == (2 * 16 + 4 * 16 + 2 * 16, 8 * 2 * 10)
    full = work.flash_work(1, 4, 4, 1, 2, 2, False)
    assert full["flash_fwd"][1] == 4 * 2 * 16


def test_paged_work_by_hand():
    # page size 4, 2 heads of 8, bf16 pages; 3 lanes: two of slot 0 at
    # lengths 5 and 6 (pages 7, 9 of its row), one of slot 1 at length 1
    tables = np.array([[7, 9, 0], [3, 0, 0]], np.int32)
    nbytes, flops = work.paged_work((3, 2, 8), 2, 4, 2, 8, 2, tables,
                                    np.array([0, 0, 1]), np.array([5, 6, 1]))
    page = 4 * 2 * 8 * 2
    assert flops == 4.0 * (5 + 6 + 1) * 2 * 8
    assert nbytes == 2 * 3 * page + 2 * 3 * 2 * 8 * 2 + 6 * 4 + 2 * 3 * 4


def test_paged_step_work_matches_the_lanes():
    """The step count from lane sums equals ``paged_work`` over the
    lane arrays it stands for (two requests, one padding lane)."""
    ps, heads, d, width = 4, 2, 8, 6
    tables = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    # request A (slot 0): decode at position 9; B (slot 1): a chunk of
    # positions 0..3; one padding lane (slot 2, the sink row, length 1)
    slots = np.array([0, 1, 1, 1, 1, 2])
    lens = np.array([10, 1, 2, 3, 4, 1])
    want = work.paged_work((width, heads, d), 2, ps, heads, d, 2, tables,
                           slots, lens)
    got = work.paged_step_work(5, 3 + 1, 10 + 1 + 2 + 3 + 4, width, heads,
                               d, 2, 2, ps, tables.size)
    page = ps * heads * d * 2
    assert got[1] == want[1]
    assert got[0] == want[0] - 2 * page    # the sink page is not counted


def test_opt_counts():
    cfg = json.loads((CONFIGS / "opt-1.3b-train.json").read_text())
    n = work.opt_matmul_params(cfg)
    assert n == 24 * (4 * 2048 ** 2 + 2 * 2048 * 8192) + 2048 * 50272
    assert n == pytest.approx(1.311e9, rel=1e-3)
    step = work.opt_train_step_flops(cfg, 8, 2048)
    assert step == 8 * 2048 * (6.0 * n + 6.0 * 24 * 2048 * 2048)
    assert step == pytest.approx(138.8e12, rel=1e-3)


def test_roofline_takes_the_larger_bound():
    peaks = {"bf16_flops": 1e12, "hbm_bytes_s": 1e9}
    assert work.roofline_seconds(2e9, 1e12, peaks) == 2.0
    assert work.roofline_seconds(1e9, 3e12, peaks) == 3.0
