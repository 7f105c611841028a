"""The conv and MLP models of the sweep and the seq2seq NMT, trained in
both packages on the CPU from the JAX model's exported weights.

Each model at the sizes of tests/test_models.py — AlexNet b=8 at 32,
ResNet-18 b=4 and ResNet-50 b=2 at 32, Inception-v3 b=2 at 32,
CANDLE-Uno b=8 (small towers), the seq2seq b=8 with src 6 and tgt 5 —
is built by the JAX builder and the port's, the JAX weights and
BatchNorm running statistics carried into the port
(``load_jax_params``), then: the eval forward on those weights; a
5-step SGD trajectory (the loss of every step, every weight and the
running statistics through ``get_states`` after the first step and
after the fifth); and the eval forward after it, on the trained running
statistics. ``conv_layout='NHWC'`` (ResNet-18 trained, and Inception's
forward) and ``sibling_conv_fusion`` off (Inception's forward; on is
the default, and Inception and ResNet-50 have sibling groups) are held
against JAX with the same knob.

Tolerances. Forwards on the exported weights: 1e-5 absolute on
probabilities (conv and matmul summation order). AlexNet, CANDLE-Uno
and the seq2seq: fixed limits, about five times the largest difference
seen (loss relative 1e-6, weights absolute 1e-6, the forward after
training 1e-5).

The BatchNorm nets (ResNet-18 in both layouts, ResNet-50, Inception)
are held against JAX's own conditioning, read from JAX alone: the same
JAX model trained again from its weights moved by one ulp each (up or
down at random), three times from three numpy seeds, each measure taken
at its largest over the three. A deep ReLU net's gradient is not continuous: an
activation that crosses 0 under a rounding change moves the update of
every weight below it. At these sizes one ulp of the weights moves
JAX's first update of ResNet-50 and Inception by 2-2.5% (ResNet-18:
3e-5), and by the fifth step by about 100% of the update (ResNet-18:
13%). Every measure of the port against JAX — each
step's loss (relative), the update of all weights together and of each
weight (relative to its own update, or to 1% of the model's largest),
each running statistic's change (the same), and the forward after
training (absolute) — is held within SPREAD_FACTOR times the same
measure of that one-ulp run, plus a floor for measures the witness
leaves at 0. The first step is where a fault shows: the planted-fault
tests below hold that these limits reject an unbiased running
variance, running statistics left unchanged, BatchNorm's epsilon at
1e-3, and a conv kernel that never moved. The JAX models are built and
compiled once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.models import build_alexnet as jalexnet
from flexflow_tpu.models import build_candle_uno as jcandle
from flexflow_tpu.models import build_inception_v3 as jinception
from flexflow_tpu.models import build_resnet as jresnet
from flexflow_tpu.models.nmt_lstm import build_nmt_seq2seq as jseq2seq

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.ops.conv import BatchNorm


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


STEPS = 5
LR = 0.005
FWD_ATOL = 1e-5
# (loss rtol, weight atol, forward-after-training atol)
TOL = {"alexnet": (1e-6, 1e-6, 1e-5), "candle_uno": (1e-6, 1e-6, 1e-5),
       "seq2seq": (1e-6, 1e-6, 1e-5)}
# held against JAX's one-ulp witness instead
WITNESS = {"resnet18", "resnet18_nhwc", "resnet50", "inception"}
SPREAD_FACTOR = 4.0
WITNESS_SEEDS = 3
# floors of the witness limits: loss (relative; an f32 forward through
# 50 layers in another summation order, as FWD_ATOL), updates and
# running statistics (relative to their change), probabilities
# (absolute)
FLOOR = {"loss": 1e-5, "update": 1e-5, "state": 1e-5, "probs": 1e-6}
# an update or a statistic's change is measured against this share of
# the model's largest where its own is smaller (a conv bias before a
# BatchNorm: its true gradient is 0, what moves it is rounding)
CHANGE_FLOOR = 1e-2

CANDLE = dict(feature_shapes={"dose1": 1, "rnaseq": 64, "drug": 128},
              tower_layers=(32, 16), final_layers=(32, 16))
S2S = dict(src_len=6, tgt_len=5, vocab_size=32, embed_dim=16, hidden=16)

# name: (jax builder, port builder, kwargs, batch, loss, config)
MODELS = {
    "alexnet": (jalexnet, ft.build_alexnet, dict(image_size=32), 8,
                "sparse_categorical_crossentropy", {}),
    "resnet18": (jresnet, ft.build_resnet, dict(depth=18, image_size=32), 4,
                 "sparse_categorical_crossentropy", {}),
    "resnet18_nhwc": (jresnet, ft.build_resnet,
                      dict(depth=18, image_size=32), 4,
                      "sparse_categorical_crossentropy",
                      {"conv_layout": "NHWC"}),
    "resnet50": (jresnet, ft.build_resnet, dict(depth=50, image_size=32), 2,
                 "sparse_categorical_crossentropy", {}),
    "inception": (jinception, ft.build_inception_v3, dict(image_size=32), 2,
                  "sparse_categorical_crossentropy", {}),
    "candle_uno": (jcandle, ft.build_candle_uno, CANDLE, 8,
                   "mean_squared_error", {}),
    "seq2seq": (jseq2seq, ft.build_nmt_seq2seq, S2S, 8,
                "sparse_categorical_crossentropy", {}),
}


def _port(name, config_over=None):
    """The port's model, compiled (weights from its own seed)."""
    _, pb, kw, bs, loss, cfg = MODELS[name]
    cfg = {**cfg, **(config_over or {})}
    pff = pb(ft.FFConfig(batch_size=bs, **cfg), batch_size=bs,
             device="cpu", **kw)
    pff.compile(optimizer=ft.SGDOptimizer(lr=LR), loss_type=loss,
                metrics=[])
    return pff


def _build(name, config_over=None):
    jb, _, kw, bs, loss, cfg = MODELS[name]
    cfg = {**cfg, **(config_over or {})}
    jcfg = JConfig()
    jcfg.batch_size = bs
    for k, v in cfg.items():
        setattr(jcfg, k, v)
    jff = jb(jcfg, batch_size=bs, **kw)
    jff.compile(optimizer=JSGD(lr=LR), loss_type=loss, metrics=[])
    pff = _port(name, config_over)
    ft.load_jax_params(
        pff, {op.name: jff.get_weights(op.name) for op in jff.ops
              if op.weight_specs()},
        {op.name: jff.get_states(op.name) for op in jff.ops
         if op.state_specs()})
    return jff, pff


def _batches(name, n, seed=0):
    _, _, kw, bs, _, _ = MODELS[name]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if name == "candle_uno":
            b = {k: rng.standard_normal((bs, d)).astype(np.float32)
                 for k, d in CANDLE["feature_shapes"].items()}
            b["label"] = rng.standard_normal((bs, 1)).astype(np.float32)
        elif name == "seq2seq":
            b = {"src": rng.integers(0, 32, (bs, 6)).astype(np.int32),
                 "tgt": rng.integers(0, 32, (bs, 5)).astype(np.int32)}
            b["label"] = np.roll(b["tgt"], -1, axis=1)
        else:
            b = {"input": rng.standard_normal(
                (bs, 3, 32, 32)).astype(np.float32),
                 "label": rng.integers(0, 10, bs).astype(np.int32)}
        out.append(b)
    return out


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "label"}


def _assert_forward(jff, pff, batch):
    want = np.asarray(jff.forward(_inputs(batch)), np.float32)
    got = pff.forward(_inputs(batch)).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


def _snapshot(ff):
    """(weights, states) of a model as {op.name.key: numpy copy}."""
    return ({f"{op.name}.{k}": np.array(v, np.float32)
             for op in ff.ops if op.weight_specs()
             for k, v in ff.get_weights(op.name).items()},
            {f"{op.name}.{k}": np.array(v, np.float32)
             for op in ff.ops if op.state_specs()
             for k, v in ff.get_states(op.name).items()})


def _tree(flat):
    """{op.name.key: array} as {op.name: {key: array}}."""
    out = {}
    for k, v in flat.items():
        op, key = k.rsplit(".", 1)
        out.setdefault(op, {})[key] = v
    return out


def _run(ff, batches, steps=STEPS):
    """Train ``steps`` steps; the losses, (weights, states) before, after
    the first step and after the last, and the eval forward after."""
    start = _snapshot(ff)
    losses, first = [], None
    for b in batches[:steps]:
        losses.append(float(ff.train_batch(b)["loss"]))
        first = first or _snapshot(ff)
    probs = np.asarray(ff.forward(_inputs(batches[-1])), np.float32)
    return {"losses": np.array(losses), "start": start, "first": first,
            "last": _snapshot(ff), "probs": probs}


def _move_one_ulp(jff, weights, states, seed=0):
    """Set a JAX model's weights to ``weights`` moved by one ulp each,
    up or down at random, and its states to ``states``."""
    rng = np.random.default_rng(seed)
    for op in sorted(weights):
        jff.set_weights(op, {k: np.nextafter(v, np.where(
            rng.random(v.shape) < 0.5, np.float32(np.inf),
            np.float32(-np.inf))).astype(np.float32)
            for k, v in sorted(weights[op].items())})
    for op, st in states.items():
        jff.set_states(op, st)


def _change_errs(start, a, b):
    """({key: ||a - b|| / max(||b - start||, CHANGE_FLOOR x the largest
    such change)}, the same over all keys concatenated)."""
    change = {k: float(np.linalg.norm(b[k] - start[k])) for k in b}
    floor = CHANGE_FLOOR * max(change.values() or [0.0])
    each = {k: float(np.linalg.norm(a[k] - b[k])) / max(change[k], floor)
            for k in b}
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in b)
    den = sum(c * c for c in change.values())
    return each, (np.sqrt(num / den) if den else 0.0)


def measures(run, ref, steps=STEPS):
    """The measures of ``run`` against ``ref`` (both from the same start):
    each step's relative loss error; after the first step and the last,
    the worst weight's and all weights' update errors and the same for
    the running statistics; the forward after training."""
    out = {"loss": np.abs(run["losses"] - ref["losses"])
           / np.abs(ref["losses"])}
    for when in ("first", "last") if steps > 1 else ("first",):
        for i, what in ((0, "update"), (1, "state")):
            each, total = _change_errs(ref["start"][i], run[when][i],
                                       ref[when][i])
            out[f"{what}_each_{when}"] = max(each.values() or [0.0])
            out[f"{what}_all_{when}"] = total
    if steps > 1:
        out["probs"] = float(np.abs(run["probs"] - ref["probs"]).max())
    return out


def limits(witness):
    """SPREAD_FACTOR times each measure of the one-ulp run, plus its
    floor. A step's loss is held to the largest loss difference the
    witness reached by that step: past the first, the two JAX runs
    drift apart and back by chance."""
    envelope = dict(witness, loss=np.maximum.accumulate(witness["loss"]))
    return {k: SPREAD_FACTOR * v + FLOOR[k.split("_")[0]]
            for k, v in envelope.items()}


def violations(got, lim):
    """The measures past their limits: {name: (value, limit)}."""
    out = {}
    for k, v in got.items():
        bad = np.asarray(v) > np.asarray(lim[k])
        if np.any(bad):
            out[k] = (v, lim[k])
    return out


_RUNS = {}


def train_pair(name):
    """The forward check, then 5 steps in both packages (and, for the
    BatchNorm nets, JAX's one-ulp run); cached for the module."""
    if name in _RUNS:
        return _RUNS[name]
    jff, pff = _build(name)
    batches = _batches(name, STEPS + 1)
    _assert_forward(jff, pff, batches[-1])
    w0 = {op.name: jff.get_weights(op.name) for op in jff.ops
          if op.weight_specs()}
    s0 = {op.name: jff.get_states(op.name) for op in jff.ops
          if op.state_specs()}
    res = dict(name=name, jax=_run(jff, batches), port=_run(pff, batches),
               batches=batches, pff=pff)
    if name in WITNESS:
        # each measure's largest over WITNESS_SEEDS one-ulp runs
        runs = []
        for seed in range(WITNESS_SEEDS):
            _move_one_ulp(jff, w0, s0, seed)
            runs.append(measures(_run(jff, batches), res["jax"]))
        res["witness"] = {k: np.maximum.reduce([r[k] for r in runs])
                          for k in runs[0]}
        res["measures"] = measures(res["port"], res["jax"])
        res["limits"] = limits(res["witness"])
        for k, v in res["measures"].items():     # shown under -s
            print(f"{name} {k}: port {v}, witness {res['witness'][k]}, "
                  f"limit {res['limits'][k]}")
    _RUNS[name] = res
    return res


# the BatchNorm pair at batch 2 trains in test_torch_conv_models_deep.py,
# on another worker
DEEP = {"resnet50", "inception"}
HERE = sorted(set(MODELS) - DEEP)


@pytest.fixture(scope="module", params=HERE)
def trained(request):
    return train_pair(request.param)


def _check(trained, *prefixes):
    """Assert the witness measures with these prefixes are within their
    limits."""
    got = {k: v for k, v in trained["measures"].items()
           if k.startswith(prefixes)}
    assert got and not violations(got, trained["limits"]), (
        violations(got, trained["limits"]), trained["witness"])


def test_trajectory_losses(trained):
    jl, pl = trained["jax"]["losses"], trained["port"]["losses"]
    if trained["name"] in WITNESS:
        _check(trained, "loss")
    else:
        np.testing.assert_allclose(pl, jl, rtol=TOL[trained["name"]][0],
                                   atol=0)


def test_trajectory_weights(trained):
    jw, pw = trained["jax"]["last"][0], trained["port"]["last"][0]
    assert set(pw) == set(jw)
    if trained["name"] in WITNESS:
        _check(trained, "update")
        return
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], rtol=0,
                                   atol=TOL[trained["name"]][1], err_msg=k)


def test_trajectory_running_stats(trained):
    name = trained["name"]
    js, ps = trained["jax"]["last"][1], trained["port"]["last"][1]
    assert bool(js) == (name in WITNESS)
    assert set(ps) == set(js)
    if js:
        _check(trained, "state")
    for k in ps:
        # the statistics moved from their initial 0 / 1
        assert not np.allclose(ps[k], 0.0 if k.endswith("running_mean")
                               else 1.0)


def test_forward_after_training(trained):
    """Eval on each package's own trained weights and running
    statistics."""
    if trained["name"] in WITNESS:
        _check(trained, "probs")
    else:
        np.testing.assert_allclose(trained["port"]["probs"],
                                   trained["jax"]["probs"], rtol=0,
                                   atol=TOL[trained["name"]][2])


def _unbiased_running_var(monkeypatch):
    orig = BatchNorm.forward

    def forward(self, params, xs, ctx):
        ys = orig(self, params, xs, ctx)
        if ctx.training:
            n = xs[0].numel() // xs[0].shape[1]
            m, old = self.MOMENTUM, ctx.state_in["running_var"]
            var = (ctx.state_out["running_var"] - m * old) / (1 - m)
            ctx.state_out["running_var"] = (m * old
                                            + (1 - m) * var * n / (n - 1))
        return ys
    monkeypatch.setattr(BatchNorm, "forward", forward)


def _running_state_unchanged(monkeypatch):
    orig = BatchNorm.forward

    def forward(self, params, xs, ctx):
        ys = orig(self, params, xs, ctx)
        ctx.state_out.update(ctx.state_in)
        return ys
    monkeypatch.setattr(BatchNorm, "forward", forward)


def _bn_eps(monkeypatch):
    monkeypatch.setattr(BatchNorm, "EPS", 1e-3)


# fault: (planted into the port's BatchNorm, or None for a run whose
# largest-moving conv kernel is put back where it started; the measures
# that must reject it)
FAULTS = {
    "unbiased_running_var": (_unbiased_running_var, ("state",)),
    "running_state_unchanged": (_running_state_unchanged, ("state",)),
    "bn_eps_1e-3": (_bn_eps, ("loss", "update", "state")),
    "frozen_conv_kernel": (None, ("update",)),
}


def planted_fault_rejected(trained, fault, monkeypatch):
    """The port's first step with a planted fault, measured against
    JAX's: each measure family the fault must move is past its limit."""
    plant, families = FAULTS[fault]
    if plant is None:
        run = dict(trained["port"])
        start, (w, s) = run["start"], run["first"]
        kernels = {k: np.linalg.norm(w[k] - start[0][k]) for k in w
                   if k.endswith(".kernel") and w[k].ndim == 4}
        k = max(kernels, key=kernels.get)
        run["first"] = ({**w, k: start[0][k]}, s)
    else:
        # the trained port model again from the start (SGD keeps no
        # slots), its BatchNorm faulty
        plant(monkeypatch)
        pff = trained["pff"]
        weights, states = trained["jax"]["start"]
        ft.load_jax_params(pff, _tree(weights), _tree(states))
        run = _run(pff, trained["batches"], steps=1)
    jax_first = dict(trained["jax"], losses=trained["jax"]["losses"][:1])
    got = measures(dict(run, losses=run["losses"][:1]), jax_first, steps=1)
    lim = {k: v[:1] if k == "loss" else v
           for k, v in trained["limits"].items()}
    bad = violations(got, lim)
    for fam in families:
        assert any(k.startswith(fam) for k in bad), (fam, got, lim)


@pytest.fixture(scope="module", params=sorted(WITNESS - DEEP))
def witnessed(request):
    return train_pair(request.param)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_rejected(witnessed, fault, monkeypatch):
    planted_fault_rejected(witnessed, fault, monkeypatch)


@pytest.mark.parametrize("knob", [{"conv_layout": "NHWC"},
                                  {"sibling_conv_fusion": False}],
                         ids=["nhwc", "no_sibling_fusion"])
def test_inception_knob_forward(knob):
    jff, pff = _build("inception", knob)
    if "sibling_conv_fusion" in knob:
        assert not pff.executor._conv_merge_leader
    else:
        assert pff.executor._nhwc_resident
    _assert_forward(jff, pff, _batches("inception", 1, seed=3)[0])


def test_sibling_groups_match_jax():
    """The port groups the same sibling convs as the JAX executor:
    Inception's 1x1 heads, ResNet-50's first conv1 and projection."""
    from flexflow_tpu.core.fusion import conv_sibling_groups as jgroups

    from flexflow_tpu_torch.core.fusion import conv_sibling_groups
    for name in ("inception", "resnet50"):
        jb, pb, kw, bs, _, _ = MODELS[name]
        jcfg = JConfig()
        jcfg.batch_size = bs
        jff = jb(jcfg, batch_size=bs, **kw)
        pff = pb(ft.FFConfig(batch_size=bs), batch_size=bs, device="cpu",
                 **kw)
        want = [[op.name for op in g] for g in jgroups(jff)]
        got = [[op.name for op in g] for g in conv_sibling_groups(pff)]
        assert got == want and got


def test_flops_match_jax():
    """Op.flops() over every op of each model equals the JAX count."""
    for name, (jb, pb, kw, bs, _, _) in MODELS.items():
        jcfg = JConfig()
        jcfg.batch_size = bs
        jff = jb(jcfg, batch_size=bs, **kw)
        pff = pb(ft.FFConfig(batch_size=bs), batch_size=bs, device="cpu",
                 **kw)
        assert [op.name for op in pff.ops] == [op.name for op in jff.ops]
        for jop, pop in zip(jff.ops, pff.ops):
            assert pop.flops() == jop.flops(), (name, jop.name)


def test_bf16_alexnet_forward():
    """dtype=bfloat16: bf16 activations over f32 masters, the forward
    within bf16 rounding of JAX's (2e-2 of the largest probability)."""
    jcfg = JConfig()
    jcfg.batch_size = 8
    jff = jalexnet(jcfg, batch_size=8, image_size=32, dtype=jnp.bfloat16)
    jff.compile(optimizer=JSGD(lr=LR), metrics=[])
    pff = ft.build_alexnet(ft.FFConfig(batch_size=8), batch_size=8,
                           image_size=32, dtype=torch.bfloat16,
                           device="cpu")
    pff.compile(optimizer=ft.SGDOptimizer(lr=LR), metrics=[])
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    assert pff.state.params["conv2d"]["kernel"].dtype.is_floating_point
    x = _inputs(_batches("alexnet", 1, seed=4)[0])
    want = np.asarray(jff.forward(x), np.float32)
    got = pff.forward(x).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def _bn_net(layout="NCHW"):
    m = ft.FFModel(ft.FFConfig(batch_size=4, seed=3, conv_layout=layout),
                   device="cpu")
    x = m.create_tensor((4, 3, 12, 12), name="input")
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="c1")
    t = m.batch_norm(t, name="bn1")
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, name="p1")
    t = m.flat(t, name="flat")
    m.dense(t, 5, name="fc")
    m.compile(optimizer=ft.SGDOptimizer(lr=0.05, momentum=0.9),
              metrics=["accuracy"])
    return m


def _state_tensors(m):
    return {f"{t}.{op}.{k}": v.detach().clone()
            for t, tree in (("p", m.state.params), ("s", m.state.states),
                            ("v", m.state.opt_state.get("v", {})))
            for op, p in tree.items() for k, v in p.items()}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_bn_crash_and_resume_bit_exact(tmp_path, layout):
    """A BatchNorm model killed at a dispatch of epoch 1 and run again
    from its checkpoint equals an uninterrupted run bit for bit: weights,
    momentum slots and running statistics (core/checkpoint.py saves the
    op states with the parameters)."""
    from flexflow_tpu_torch.utils import faults
    rng = np.random.default_rng(8)
    x = rng.standard_normal((16, 3, 12, 12)).astype(np.float32)
    y = rng.integers(0, 5, 16).astype(np.int32)
    ref = _bn_net(layout)
    ref.fit({"input": x}, y, epochs=2, verbose=False)
    ckpt = str(tmp_path / "ck")
    with faults.active("train.dispatch:kill@6"):
        with pytest.raises(faults.SimulatedKill):
            _bn_net(layout).fit({"input": x}, y, epochs=2, verbose=False,
                                checkpoint_dir=ckpt)
    again = _bn_net(layout)
    hist = again.fit({"input": x}, y, epochs=2, verbose=False,
                     checkpoint_dir=ckpt)
    assert [h["epoch"] for h in hist] == [1]
    want, got = _state_tensors(ref), _state_tensors(again)
    assert set(want) == set(got) and any(k.startswith("s.") for k in want)
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_accumulated_steps_carry_bn_state_in_order():
    """train_batch_accum advances the running statistics microbatch by
    microbatch, as JAX's scan carries them: equal to the same
    microbatches' forwards in order."""
    m, ref = _bn_net(), _bn_net()
    rng = np.random.default_rng(9)
    micro = [{"input": rng.standard_normal((4, 3, 12, 12)).astype(
        np.float32), "label": rng.integers(0, 5, 4).astype(np.int32)}
        for _ in range(3)]
    m.train_batch_accum(micro)
    ex = ref.executor
    for b in micro:
        with torch.no_grad():
            ex._outputs_and_loss(ref.state.params, ex.shard_batch(b), True,
                                 states=ref.state.states)
    for k in ("running_mean", "running_var"):
        assert torch.equal(m.state.states["bn1"][k],
                           ref.state.states["bn1"][k]), k
