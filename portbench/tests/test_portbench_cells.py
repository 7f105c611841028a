"""Whole runs of tiny cells on the CPU, past the look for a chip: a new
cell, mix, configuration and metric are found by name; a sound run is
correct; each fault a cell can have, planted under the timed path, and
the control (the reference one precision down, in the program's
place) make ``correct`` false.

The tiny cells' limits are this test's own, read from these seeds at
these sizes: sound serving runs read 0.0 to 0.0026 served-logit gap
over 200 tokens, the fp8 control 0.011 to 0.028; sound training runs
(seeds 3-8) 0.003-0.016 gradient-norm gap, 0.007-0.015 change-norm gap
and 5e-6 to 4e-5 loss gap; the control 0.025-0.034 gradient-norm gap,
half a batch 0.61, an unchanged state 1.0 on the change, a batch fed
twice in a call 0.077-0.106 on the change and 4.1e-3 to 5.7e-3 on the
loss.
"""

import json
import shutil

import pytest
import torch

import portbench_tiny as T
from flexflow_tpu_torch.models.transformer import TransformerLM
from flexflow_tpu_torch.serve.engine import ServeEngine
from portbench.harness import serve_cell, train_cell, weights
from portbench.harness.registry import Registry
from portbench.reference import opt as ref


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return T.make(tmp_path_factory.mktemp("bench"))


def _run(base, cell, **kw):
    out = T.run(base, cell, seconds=0.5, **kw)
    return out, out.pop("_run")


def test_a_new_cell_mix_config_and_metric_are_found_by_name(tmp_path):
    base = T.make(tmp_path)
    reg = Registry(base)
    shutil.copy(base / "configs/tiny-serve.json",
                base / "configs/tiny-serve-b.json")
    mix = json.loads((base / "traffic/tiny-loop.json").read_text())
    mix["clients"] = 2
    (base / "traffic/tiny-two.json").write_text(json.dumps(mix))
    (base / "workloads/tiny-two.json").write_text(json.dumps({
        "config": "tiny-serve-b", "traffic": "tiny-two", "chips": 1,
        "why": "two clients", "limits": {"served_logit_gap": 0.05}}))
    (base / "metrics/requests_done.py").write_text(
        "def read(run):\n"
        "    return sum(1 for r in run.requests if run.in_window(r.t_done))\n")
    bench = json.loads(reg.bench_file.read_text())
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny-two"]})
    reg.bench_file.write_text(json.dumps(bench))
    assert "tiny-two" in reg.names("workloads")
    assert "requests_done" in reg.names("metrics")
    out, run = _run(base, "tiny-two", seed=11)
    assert run.mix["clients"] == 2 and run.config["kind"] == "serve"
    assert set(out["metrics"]) == {"requests_done", "setup_s"}
    assert out["metrics"]["requests_done"]["value"] == out["attempted"] > 0
    assert out["correct"] is True


def test_serve_sound_run_is_correct(base):
    out, run = _run(base, "tiny-serve", seed=11)
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"output_tokens_per_s", "tpot_p95_ms",
                                   "ttft_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    assert run.info["tokens"] >= 24


def test_serve_traced_run_reports_per_layer_metrics(base):
    out, run = _run(base, "tiny-serve", seed=12, trace=True)
    assert out["correct"] is True
    # the CPU run has no device trace: its readers find nothing to read
    assert set(out["metrics"]) == {"queue_wait_ms.serve", "lane_fill.serve",
                                   "step_wall_ms.serve", "mfu.serve"}


def test_serve_token_altered_where_produced(base, monkeypatch):
    pick = ServeEngine._pick_token

    def altered(self, req, greedy, topv, topi):
        tok = pick(self, req, greedy, topv, topi)
        return (tok + 1) % self.vocab_size if len(req.out_tokens) == 2 \
            else tok
    monkeypatch.setattr(ServeEngine, "_pick_token", altered)
    out, _ = _run(base, "tiny-serve", seed=11)
    assert out["correct"] is False


def test_serve_half_the_batch_left_out(base, monkeypatch):
    """The mixed step computes only the first half of its lanes; the
    rest carry the zero embedding through the layers."""
    embed = TransformerLM.embed

    def half(self, tokens, positions):
        x = embed(self, tokens, positions)
        if x.dim() == 2:
            x = x.clone()
            x[x.shape[0] // 2:] = 0
        return x
    monkeypatch.setattr(TransformerLM, "embed", half)
    out, _ = _run(base, "tiny-serve", seed=11)
    assert out["correct"] is False


def test_serve_control_fails(base):
    """The reference in fp8 in the program's place: the gaps of the
    tokens it puts first, over every request the run completed, exceed
    the limit."""
    for seed in (12, 14):
        out, run = _run(base, "tiny-serve", seed=seed)
        reqs = [r for r in run.requests if r.outcome == "completed"]
        w = weights.make_tree(run.config, seed, "cpu",
                              stored_dtype=torch.bfloat16)
        gap = serve_cell.served_gap(w, run.config, reqs, mm=ref.fp8_matmul)
        assert gap > run.workload["limits"]["served_logit_gap"], gap


def test_train_sound_run_is_correct(base):
    out, run = _run(base, "tiny-train", seed=3)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert out["attempted"] == sum(c.steps for c in run.fit_calls) > 0


def test_train_step_returns_its_state_unchanged(base, monkeypatch):
    import flexflow_tpu_torch.core.optimizers as O
    monkeypatch.setattr(O.AdamOptimizer, "update",
                        lambda self, params, grads, state, step, scalar=None:
                        (params, state))
    out, run = _run(base, "tiny-train", seed=3)
    assert out["correct"] is False
    assert run.checks["update_norm_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch_left_out(base, monkeypatch):
    import flexflow_tpu_torch.core.losses as L
    full = L.sparse_categorical_crossentropy

    def half(logits, labels, from_logits=False):
        n = logits.shape[0] // 2
        return full(logits[:n], labels[:n], from_logits=from_logits)
    monkeypatch.setattr(L, "sparse_categorical_crossentropy", half)
    out, _ = _run(base, "tiny-train", seed=3)
    assert out["correct"] is False


def test_train_batch_fed_twice_in_a_call_of_several_steps(base, monkeypatch):
    """The loader feeds a call's first batch again in its second step: a
    fault only calls of several steps have, as the window's calls do."""
    from flexflow_tpu_torch.core.dataloader import DataLoaderSet
    orig = DataLoaderSet.iter_with_order

    def twice(self, order):
        bs = self.batch_size
        if len(order) >= 2 * bs:
            order = order.copy()
            order[bs:2 * bs] = order[:bs]
        return orig(self, order)
    monkeypatch.setattr(DataLoaderSet, "iter_with_order", twice)
    out, run = _run(base, "tiny-train", seed=3)
    assert out["correct"] is False, run.checks


def test_train_control_fails(base):
    reg = Registry(base)
    wl, mc, mix = reg.cell("tiny-train")
    b, s, n = mix["batch"], mix["seq"], 1 + mix["steps_per_call"]
    lr, gr, cr = train_cell.reference_steps(mc, 7, "cpu", n, b, s)
    lc, gc, cc = train_cell.reference_steps(mc, 7, "cpu", n, b, s,
                                            mm=ref.fp8_matmul)
    found = train_cell.gaps(lc, lr, gc, gr, cc, cr)
    assert any(found[k] > lim for k, lim in wl["limits"].items()), found
