"""The port's ProgramRegistry (core/programs.py) on the CPU: it counts
one signature per (family, argument shapes) and runs every call
eagerly; the serving engine's and the executor's counts equal the JAX
engine's and executor's on the same geometry, mixed and legacy alike,
after warmup() and after generate().

Both engines register the same six families: the serving steps and
``adapter``, ``export`` and ``import`` (LoRA adapters and the host
tier, 0 on these unarmed engines); every family must read what the JAX
one reads.
"""

from functools import partial

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.core.losses import \
    sparse_categorical_crossentropy as jscce
from flexflow_tpu.models.transformer import \
    build_transformer_lm as jbuild_lm
from flexflow_tpu.serve import ServeEngine as JEngine

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core.losses import \
    sparse_categorical_crossentropy as pscce
from flexflow_tpu_torch.core.programs import (PinnedRing, ProgramRegistry,
                                              fingerprint_hash)
from flexflow_tpu_torch.kernels import _launches
from flexflow_tpu_torch.serve import ServeEngine as TorchEngine


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The port's CPU computations here run at test shapes, and beside
    other test workers on one host each worker's intra-op thread pool
    oversubscribes the cores (a serving case that takes 2 s alone took
    25 s beside two other workers). One thread for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GEOMETRY = dict(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                serve_prefill_budget=48)
ARCH = dict(vocab_size=89, max_seq_len=64, hidden=32, num_heads=4,
            num_layers=2, ff_dim=64)


# ------------------------------------------------------------ registry
def test_cpu_registry_counts_signatures_and_runs_eagerly():
    reg = ProgramRegistry({"model": "x"}, "cpu")
    assert not reg.capture
    reg.register("step")
    calls = []

    def fn(x, k):
        calls.append(k)
        return x * k

    a = torch.ones(3)
    assert torch.equal(reg.call("step", fn, a, 2), 2 * a)
    assert torch.equal(reg.call("step", fn, 3 * a, 2), 6 * a)
    assert reg.compile_counts() == {"step": 1}
    reg.call("step", fn, torch.ones(4), 2)            # a new shape
    reg.call("step", fn, torch.ones(4, dtype=torch.float64), 2)
    reg.call("step", fn, a, 5)                        # a new static value
    reg.call("other", fn, a, 2)                       # registered on call
    assert reg.compile_counts() == {"step": 4, "other": 1}
    assert reg.replay_counts() == {"step": 0, "other": 0}
    assert calls == [2, 2, 2, 2, 5, 2]                # every call ran
    rec = reg.boot_record()
    assert rec["compiles"] == 5 and not rec["captured"]
    assert rec["fingerprint"] == fingerprint_hash({"model": "x"})
    reg.release()
    reg.call("step", fn, a, 2)
    assert reg.compile_counts()["step"] == 5


def test_capture_off_is_eager_on_any_device():
    reg = ProgramRegistry({}, "cpu", capture=False)
    assert not reg.capture
    assert reg.signature((torch.zeros(2, 3, dtype=torch.int32), None)) == (
        ("t", (2, 3), "torch.int32"), ("s", "None"))


def test_pinned_ring_on_cpu_hands_out_writable_slots():
    ring = PinnedRing("cpu", depth=2)
    a = ring.take(5, torch.int32)
    a.fill_(7)
    ring.consumed()
    b = ring.take(3, torch.float32)
    assert a.numel() == 5 and b.numel() == 3 and b.dtype == torch.float32
    assert ring.take(5, torch.int32).data_ptr() == a.data_ptr()


def test_recorded_launches_count_at_every_replay():
    """A launch inside a capture is counted at each replay of its graph
    (kernels/_launches.py); outside a capture, at once."""
    table = {"k": 0}
    _launches.count_launch(table, "k")
    assert table == {"k": 1}
    rec = _launches.start_recording()
    try:
        with pytest.raises(RuntimeError):
            _launches.start_recording()
        # not capturing on the CPU: counted at once, not recorded
        _launches.count_launch(table, "k", 2)
    finally:
        _launches.stop_recording()
    assert table == {"k": 3} and rec == []
    _launches.replay_launches([(table, "k", 4)])
    assert table == {"k": 7}


# -------------------------------------------------------------- engines
def _jax_counts(counts):
    """The JAX engine's counts, family by family (the adapter and
    handoff families must be 0 on these unarmed engines)."""
    assert {k: counts[k] for k in ("adapter", "export", "import")} == \
        dict.fromkeys(("adapter", "export", "import"), 0)
    return dict(counts)


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["mixed", "legacy"])
def test_engine_counts_equal_jax(chunked):
    cfg = dict(GEOMETRY, serve_chunked_prefill=chunked)
    jff = jbuild_lm(JConfig(batch_size=1, **cfg), **ARCH)
    jeng = JEngine(jff)
    params = {op: {k: np.asarray(v) for k, v in p.items()}
              for op, p in jff.state.params.items()}
    model = ft.from_jax_params(params, device="cpu")
    teng = TorchEngine(model, ft.FFConfig(**cfg), device="cpu")
    assert teng.buckets == jeng.buckets
    assert teng.compile_counts() == _jax_counts(jeng.compile_counts())
    warm = teng.warmup()
    assert warm == teng.compile_counts() == _jax_counts(jeng.warmup())
    handoff = {"adapter": 0, "export": 0, "import": 0}
    assert warm == ({"prefill": 0, "decode": 0, "mixed": 1, **handoff}
                    if chunked
                    else {"prefill": len(teng.buckets), "decode": 1,
                          "mixed": 0, **handoff})
    rng = np.random.default_rng(1)
    prompts = [[int(x) for x in rng.integers(1, 89, n)]
               for n in (5, 20, 50)] + [[3, 4] * 9]
    ours = teng.generate(prompts, 6)
    theirs = jeng.generate(prompts, 6)
    assert ours == theirs
    assert teng.compile_counts() == warm == \
        _jax_counts(jeng.compile_counts())
    assert teng.boot_stats["compiles"] == sum(warm.values())
    assert teng.programs.replay_counts() == dict.fromkeys(warm, 0)


def test_engine_serves_the_model_it_was_given():
    """ServeEngine(model) with no config serves the model's own knobs,
    and compiles a model that has no state for inference."""
    m = ft.build_transformer_lm(ft.FFConfig(batch_size=1, **GEOMETRY),
                                device="cpu", **ARCH)
    assert m.state is None
    eng = TorchEngine(m, device="cpu")
    assert eng.config is m.config and m.state is not None
    assert eng.mixed_width == 48 + 8
    eng.warmup()
    p = [[1, 2, 3, 4] * 5]
    assert eng.generate(p, 5) == eng.generate_reference(p, 5)
    eng.close()
    assert eng.generate(p, 5) == eng.generate_reference(p, 5)


def test_train_step_counts_equal_jax():
    """One train_step program a batch shape, as the JAX executor's
    registry counts it."""
    arch = dict(ARCH, max_seq_len=16)
    jff = jbuild_lm(JConfig(batch_size=2), batch_size=2, **arch)
    jff.compile(optimizer=JSGD(lr=0.01),
                loss_type=partial(jscce, from_logits=True), metrics=[])
    pff = ft.build_transformer_lm(ft.FFConfig(batch_size=2), batch_size=2,
                                  device="cpu", **arch)
    pff.compile(optimizer=ft.SGDOptimizer(lr=0.01),
                loss_type=partial(pscce, from_logits=True), metrics=[])
    rng = np.random.default_rng(0)
    for _ in range(3):
        toks = rng.integers(0, 89, (2, 16)).astype(np.int32)
        b = {"tokens": toks, "label": np.roll(toks, -1, 1),
             "positions": np.tile(np.arange(16, dtype=np.int32), (2, 1))}
        jff.train_batch(b)
        pff.train_batch(b)
    assert pff.compile_counts() == jff.compile_counts() == \
        {"train_step": 1}


def test_new_hyperparameter_keys_a_new_train_program():
    """The optimizer's hyperparameters are baked into a captured step,
    so they key it: changing the learning rate after two steps adds one
    train_step program in both packages. The port's next update uses
    the new rate; the JAX executor's jitted step keeps the old one (its
    trace cache ignores the closure), so only the port is held to it,
    against the same port run without the change."""
    arch = dict(ARCH, max_seq_len=16)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(4):
        toks = rng.integers(0, 89, (2, 16)).astype(np.int32)
        batches.append({"tokens": toks, "label": np.roll(toks, -1, 1),
                        "positions": np.tile(np.arange(16, dtype=np.int32),
                                             (2, 1))})

    def run(change):
        jff = jbuild_lm(JConfig(batch_size=2), batch_size=2, **arch)
        jff.compile(optimizer=JSGD(lr=0.01),
                    loss_type=partial(jscce, from_logits=True), metrics=[])
        pff = ft.build_transformer_lm(ft.FFConfig(batch_size=2),
                                      batch_size=2, device="cpu", **arch)
        pff.compile(optimizer=ft.SGDOptimizer(lr=0.01),
                    loss_type=partial(pscce, from_logits=True), metrics=[])
        ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                                 for op in jff.ops if op.weight_specs()})
        losses = []
        for i, b in enumerate(batches):
            if i == 2 and change:
                jff.optimizer.lr = pff.optimizer.lr = 0.5
            jff.train_batch(b)
            losses.append(float(pff.train_batch(b)["loss"]))
        assert pff.compile_counts() == jff.compile_counts() == \
            {"train_step": 1 + change}
        return losses

    kept, changed = run(False), run(True)
    assert changed[:3] == kept[:3]
    assert abs(changed[3] - kept[3]) > 1e-3     # the new rate took effect
