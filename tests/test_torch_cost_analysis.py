"""The port's cost analyses on the CPU: ``utils/profiling.hlo_cost``
(one train step's flops and bytes, the counterpart of JAX's XLA cost
analysis) against the analytic GEMM count and XLA's own count of the
same step, ``ServeEngine.mixed_step_cost_analysis``, the hand-written
kernels' counts from their launch arguments (kernels/_work.py) — the
same functions ``chip_smoke.py``'s bounds call — and that neither call
leaves a trace (weights, slots, keys, captures, launch counts, pages).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.kernels import _launches, _work
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.kernels import lstm_scan as ls
from flexflow_tpu_torch.kernels.paged_ragged_v2 import paged_work
from flexflow_tpu_torch.serve import ServeEngine
from flexflow_tpu_torch.utils.profiling import StepCost, hlo_cost

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py as a module (its main does not run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the MLP of tests/test_model.py's hlo_cost case: 8 x 16 -> 32 (relu)
# -> 10 -> softmax, SGD, sparse categorical cross-entropy
def _mlp(pkg, cfg_cls, sgd, **kw):
    cfg = cfg_cls()
    cfg.batch_size = 8
    ff = pkg.FFModel(cfg, **kw)
    x = ff.create_tensor((8, 16), name="input")
    h = ff.dense(x, 32, activation="relu", name="fc1")
    ff.softmax(ff.dense(h, 10, name="fc2"), name="sm")
    ff.compile(optimizer=sgd(lr=0.1),
               loss_type="sparse_categorical_crossentropy", metrics=[])
    return ff


def _batch():
    rng = np.random.RandomState(0)
    return {"input": rng.randn(8, 16).astype(np.float32),
            "label": rng.randint(0, 10, 8).astype(np.int32)}


# the GEMMs of one step: fc1's forward and weight gradient (the input
# takes no gradient, as in XLA's step) and fc2's forward, weight
# gradient and input gradient, 2 flops a multiply-add
GEMM_FLOPS = 2 * 8 * 16 * 32 * 2 + 2 * 8 * 32 * 10 * 3
assert GEMM_FLOPS == 31_744


def test_mlp_step_flops_against_the_gemms_and_xla():
    from flexflow_tpu import FFConfig as JConfig
    from flexflow_tpu import SGDOptimizer as JSGD
    import flexflow_tpu as jft
    from flexflow_tpu.utils.profiling import hlo_cost as jhlo_cost
    port = _mlp(ft, ft.FFConfig, ft.SGDOptimizer, device="cpu")
    ours = hlo_cost(port, _batch())
    assert ours["gemm flops"] == GEMM_FLOPS
    assert ours["kernels"] == {}
    xla = jhlo_cost(_mlp(jft, JConfig, JSGD), _batch())
    ratio = ours["flops"] / xla["flops"]
    print(f"MLP step: port flops {ours['flops']:.0f} (GEMMs "
          f"{ours['gemm flops']:.0f}), XLA {xla['flops']:.0f}, ratio "
          f"{ratio:.3f}; bytes port {ours['bytes accessed']:.0f}, XLA "
          f"{xla['bytes accessed']:.0f} (XLA counts after fusion)")
    assert 0.7 <= ratio <= 1.3
    assert ours["bytes accessed"] > 0


def test_hlo_cost_leaves_no_trace():
    m = _mlp(ft, ft.FFConfig, ft.SGDOptimizer, device="cpu")
    m.train_batch(_batch())
    w0 = {(op, k): w.clone() for op, p in m.state.params.items()
          for k, w in p.items()}
    s0 = {(slot, op, k): w.clone()
          for slot, tree in m.state.opt_state.items()
          for op, p in tree.items() for k, w in p.items()}
    step, host_step = m.state.step, m._host_step
    counts = m.compile_counts()
    rng = torch.random.get_rng_state()
    hlo_cost(m, _batch())
    assert all(torch.equal(w, w0[(op, k)])
               for op, p in m.state.params.items() for k, w in p.items())
    assert all(torch.equal(w, s0[(slot, op, k)])
               for slot, tree in m.state.opt_state.items()
               for op, p in tree.items() for k, w in p.items())
    assert (m.state.step, m._host_step) == (step, host_step)
    assert m.compile_counts() == counts
    assert torch.equal(torch.random.get_rng_state(), rng)
    # the step it counted is the step train_batch runs: the same loss
    loss = float(m.train_batch(_batch())["loss"])
    assert np.isfinite(loss)


def test_counter_silences_launch_counts_and_pauses_in_kernels():
    table = {"k": 0}
    with StepCost() as c:
        _launches.count_launch(table, "k")
        with _work.kernel("probe", lambda: (10.0, 20.0)):
            torch.ones(4) + 1                     # not counted: paused
        torch.ones(4) * 2                         # counted: 4 flops
    assert table == {"k": 0}
    assert c.kernels == {"probe": {"calls": 1, "flops": 20.0,
                                   "bytes accessed": 10.0}}
    assert c.flops == 24.0
    assert _work.active() is None
    _launches.count_launch(table, "k")
    assert table == {"k": 1}


def test_lm_step_counts_each_flash_kernel_from_its_arguments():
    b, s, h, e = 2, 16, 4, 32
    m = ft.build_transformer_lm(ft.FFConfig(batch_size=b), batch_size=b,
                                device="cpu", vocab_size=89, max_seq_len=s,
                                hidden=e, num_heads=h, num_layers=2,
                                ff_dim=64)
    from functools import partial
    from flexflow_tpu_torch.core.losses import \
        sparse_categorical_crossentropy as scce
    m.compile(optimizer=ft.SGDOptimizer(lr=0.01),
              loss_type=partial(scce, from_logits=True), metrics=[])
    toks = np.random.default_rng(0).integers(0, 89, (b, s)).astype(np.int32)
    c = hlo_cost(m, {"tokens": toks, "label": np.roll(toks, -1, 1),
                     "positions": np.tile(np.arange(s, dtype=np.int32),
                                          (b, 1))})
    work = fa.flash_work(b, s, s, h, e // h, 4, True)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        k = c["kernels"][name]
        assert k["calls"] == 2
        assert k["flops"] == 2 * work[name][1]
        assert k["bytes accessed"] == 2 * work[name][0]
    assert 0 < c["kernel flops share"] < 1


def test_mixed_step_cost_counts_kernel_1_and_leaves_no_trace():
    cfg = ft.FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                      serve_prefill_budget=48)
    m = ft.build_transformer_lm(cfg, device="cpu", vocab_size=89,
                                max_seq_len=64, hidden=32, num_heads=4,
                                num_layers=2, ff_dim=64)
    eng = ServeEngine(m, cfg, device="cpu")
    eng.warmup()
    p = [[1, 2, 3, 4] * 5]
    before = eng.generate(p, 4)
    kp, vp = eng._k_pages.clone(), eng._v_pages.clone()
    counts = eng.compile_counts()
    c = eng.mixed_step_cost_analysis()
    assert torch.equal(kp, eng._k_pages) and torch.equal(vp, eng._v_pages)
    assert eng.compile_counts() == counts
    # kernel 1 on warmup's sink-page inputs, once a layer
    t = eng.mixed_width
    q = torch.zeros((t, 4, 8))
    tables = torch.zeros((8, eng.cache_cfg.pages_per_seq), dtype=torch.int32)
    z = torch.zeros((t,), dtype=torch.int32)
    nbytes, flops = paged_work(q, eng._k_pages[0], tables, z,
                               torch.ones((t,), dtype=torch.int32))
    k = c["kernels"]["paged_ragged_v2"]
    assert k == {"calls": 2, "flops": 2 * flops,
                 "bytes accessed": 2 * nbytes}
    assert c["gemm flops"] > 0 and c["flops"] > c["gemm flops"]
    assert eng.generate(p, 4) == before


def test_smoke_bounds_read_the_kernels_counts(smoke):
    """chip_smoke.py's bound_ms is the card's rates over the same
    counts the cost analyses add."""
    rng = np.random.default_rng(0)
    kp = torch.from_numpy(rng.standard_normal((17, 16, 2, 8),
                                              np.float32))
    q = torch.zeros((5, 2, 8))
    tables = torch.from_numpy(rng.permutation(16).reshape(2, 8) + 1) \
        .to(torch.int32)
    slots = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32)
    lens = torch.tensor([1, 17, 3, 40, 128], dtype=torch.int32)
    assert smoke.attention_bound(q, kp, tables, slots, lens) == \
        smoke.bound(*paged_work(q, kp, tables, slots, lens), kp.dtype)
    # 16 + 17 live pages by hand: slot 0 reads 2, slot 1 reads 8
    assert paged_work(q, kp, tables, slots, lens)[1] == \
        4.0 * (1 + 17 + 3 + 40 + 128) * 2 * 8
    for dtype in (torch.float32, torch.bfloat16):
        e = torch.tensor([], dtype=dtype).element_size()
        for causal in (True, False):
            assert smoke.flash_bounds(dtype, causal) == {
                k: smoke.bound(*w, dtype) for k, w in fa.flash_work(
                    smoke.TB, smoke.TS, smoke.TS, smoke.TH, smoke.TD, e,
                    causal).items()}
        assert smoke.lstm_bounds(dtype) == {
            k: smoke.bound(*w, dtype) for k, w in ls.lstm_work(
                smoke.NT, smoke.NB, smoke.NH, e).items()}
        assert smoke.ch_split_bounds(dtype) == {
            k: smoke.bound(*w, dtype) for k, w in ls.lstm_split_work(
                smoke.NT, smoke.NB, smoke.NH, smoke.CH_HU, e).items()}


@pytest.mark.parametrize("causal", [True, False])
def test_flash_pairs_follow_the_mask(causal):
    """The pair count of flash_work is the mask's: queries see keys
    j <= i when causal (top-left aligned), at sq != sk too."""
    for sq, sk in ((7, 7), (5, 9), (9, 5)):
        keep = torch.ones(sq, sk).tril() if causal else torch.ones(sq, sk)
        w = fa.flash_work(1, sq, sk, 1, 1, 4, causal)
        assert w["flash_fwd"][1] == 4 * float(keep.sum())
