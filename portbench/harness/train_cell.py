"""A training cell: OPT trained through ``FFModel.fit(prefetch=True)``.

Set-up builds the model with ``build_transformer_lm``, compiles it with
Adam and the mixed-precision policy of the configuration file, writes
the seed's weights into its f32 masters, and drives it through its
first 1 + k steps, k the mix's ``steps_per_call``, on rows that all
differ: a ``fit`` call of one step (it captures the training step),
whose state gives each leaf's first gradient as Adam got it (its first
moment after one step, m / (1 - beta1)); then one call of k steps, the
window's own call, with the prefetching loader staging batches and the
dispatch window holding steps in flight. It reads each call's loss as
``fit`` returns it (the mean over the call's steps) and each leaf's
change after the 1 + k steps. The window then calls ``fit`` on the
same object, with the same feed, k steps a call, until ``--seconds``
have passed; every call ends drained, so the window ends in a
synchronize.

Every step's batch is its own seeded draw of token ids: (B, S + 1)
ids, of which the first S are the input and the last S the next-token
labels. After the window the model is freed and the plain reference
runs the same 1 + k steps from the same weights.
"""

from __future__ import annotations

import time
from functools import partial
from statistics import median
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import weights
from .record import FitCall, Run
from .serve_cell import build_model, device_facts, ff_config, free
from .trace import Profiler, reduce, span
from ..reference import opt as ref


def batch(seed: int, step: int, b: int, s: int, vocab: int):
    """(tokens (b, s), labels (b, s)) int32 of step ``step``."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0xDA7A, step])
    ids = rng.integers(0, vocab, size=(b, s + 1), dtype=np.int64)
    return ids[:, :s].astype(np.int32), ids[:, 1:].astype(np.int32)


def fit_steps(model, seed, j0, k, b, s, vocab, traced):
    """``fit`` over steps j0 .. j0 + k - 1; returns (the fit call's
    record, its mean loss)."""
    xs, ys = zip(*(batch(seed, j, b, s, vocab) for j in range(j0, j0 + k)))
    x = np.concatenate(xs)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), x.shape).copy()
    y = np.concatenate(ys)
    t0 = time.perf_counter()
    with span("train.fit", traced):
        hist = model.fit({"tokens": x, "positions": pos}, y, batch_size=b,
                         epochs=1, shuffle=False, verbose=False,
                         prefetch=True)
    t1 = time.perf_counter()
    gap = float(model.last_train_stats["dispatch_gap_s_mean"])
    return FitCall(t0, t1, k, gap, traced), float(hist[0]["loss"])


def _leaf_norms(tree) -> Dict[Tuple[str, str], float]:
    return {(op, n): float(t.float().norm()) for op, ws in tree.items()
            for n, t in ws.items()}


def checked_steps(run: Run, device, seed: int, cache_dir):
    """Set up and drive the program through its first 1 + k steps, as
    the module's docstring says, reading what the comparison needs.
    Returns (model, the two calls' losses, first gradient norms, change
    norms), norms keyed by leaf."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.core.losses import \
        sparse_categorical_crossentropy

    mc, mix = run.config, run.mix
    opt = mc["optimizer"]
    b, s = int(mix["batch"]), int(mix["seq"])
    k = int(mix["steps_per_call"])
    vocab = mc["vocab_size"]
    run.batch, run.seq = b, s
    cfg = ff_config(ft, mc["program"], batch_size=b,
                    program_cache_dir=cache_dir)
    model = build_model(ft, mc, cfg, b, s, device)
    model.compile(optimizer=ft.AdamOptimizer(
        lr=opt["lr"], beta1=opt["beta1"], beta2=opt["beta2"],
        epsilon=opt["eps"]),
        loss_type=partial(sparse_categorical_crossentropy,
                          from_logits=True), metrics=[])
    params = model.state.params
    weights.load_into(params, mc, seed)
    _, first = fit_steps(model, seed, 0, 1, b, s, vocab, False)
    m = model.state.opt_state["m"]
    grad_norms = {key: v / (1.0 - float(opt["beta1"]))
                  for key, v in _leaf_norms(m).items()}
    _, rest = fit_steps(model, seed, 1, k, b, s, vocab, False)
    change = {}
    with torch.no_grad():
        for leaves in weights.groups(mc, seed, params_device(params)):
            for op, n, w0 in leaves:
                change[(op, n)] = float(
                    (params[op][n].float() - w0).norm())
    return model, [first, rest], grad_norms, change


def call_losses(losses: List[float]) -> List[float]:
    """Per-step losses grouped as the checked calls report them: the
    first step's, and the mean of the rest."""
    return [losses[0], sum(losses[1:]) / len(losses[1:])]


def run_train(run: Run, device, seed: int, seconds: float, traced: bool,
              t_start: float, cache_dir) -> dict:
    """Set up, measure, free and judge one training run; fills ``run``.
    Returns the device facts read when the window closed."""
    model, losses, grad_norms, change = checked_steps(run, device, seed,
                                                      cache_dir)
    mix, vocab = run.mix, run.config["vocab_size"]
    b, s = run.batch, run.seq
    prof = Profiler() if traced else None
    if prof is not None:
        prof.warm(device)
    k = int(mix["steps_per_call"])
    trace_calls = int(mix.get("trace_calls", 1))
    run.w0 = time.perf_counter()
    run.setup_s = run.w0 - t_start
    end = run.w0 + seconds
    j, traced_prof = 1 + k, None
    while time.perf_counter() < end:
        mid = time.perf_counter() >= run.w0 + 0.25 * seconds
        tracing = prof is not None and traced_prof is None and mid
        if tracing:
            prof.start()
        for _ in range(trace_calls if tracing else 1):
            call, _ = fit_steps(model, seed, j, k, b, s, vocab, tracing)
            run.fit_calls.append(call)
            j += k
        if tracing:
            traced_prof = prof.stop()
    run.w1 = run.fit_calls[-1].t1
    facts = device_facts(device)
    if traced_prof is not None:
        run.trace = reduce(traced_prof)
        del traced_prof
        if run.trace is not None:
            run.info["device_s_by_class"] = run.trace.by_class
    run.attempted = sum(c.steps for c in run.fit_calls)
    del model
    free(device)
    judge(run, device, seed, losses, grad_norms, change)
    return facts


def params_device(params):
    return next(iter(next(iter(params.values())).values())).device


def gaps(losses_p, losses_r, grad_p, grad_r, change_p, change_r) -> dict:
    """The three numbers compared: the widest relative gap of a checked
    call's loss; and, by the worst leaf, the gap between the program's norm and
    the reference's of the first gradient and of the change after the
    steps, against the reference's norm of that leaf or of the median
    leaf, whichever is larger. Leaves whose reference gradient is under
    a thousandth of the median leaf's (nought to rounding) are left out
    of the change."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(losses_p, losses_r))
    med_g = median(grad_r.values())
    grad = max(abs(grad_p[k] - g) / max(g, med_g)
               for k, g in grad_r.items())
    moved = [k for k, g in grad_r.items() if g >= 1e-3 * med_g]
    med_c = median(change_r[k] for k in moved)
    upd = max(abs(change_p[k] - change_r[k]) / max(change_r[k], med_c)
              for k in moved)
    return {"loss_gap": loss, "grad_norm_gap": grad,
            "update_norm_gap": upd}


def reference_batches(mc, seed, device, n, b, s):
    """The first n steps' batches as the reference takes them."""
    out = []
    for j in range(n):
        x, y = batch(seed, j, b, s, mc["vocab_size"])
        out.append((torch.from_numpy(x).long().to(device),
                    torch.from_numpy(y).long().to(device)))
    return out


def reference_steps(mc, seed, device, n, b, s, mm=ref.f32_matmul,
                    half_batch=False):
    """The reference's n steps from the seed's weights: (the checked
    calls' losses, first gradient norms, change norms) keyed by leaf."""
    ref.exact()
    w0 = weights.make_tree(mc, seed, device)
    losses, gnorm, final = ref.train(
        w0, mc, mc["optimizer"], reference_batches(mc, seed, device, n, b, s),
        mm=mm, half_batch=half_batch)
    change = {(op, k): float((final[op][k] - w0[op][k]).norm())
              for op in w0 for k in w0[op]}
    grad = {(op, k): v for (op, k), v in gnorm.items()}
    return call_losses(losses), grad, change


def judge(run: Run, device, seed, losses, grad_norms, change) -> None:
    """The reference's 1 + k steps beside the program's: every number
    the cell's ``limits`` name is compared; any other is printed for
    the record."""
    mc = run.config
    t = time.perf_counter()
    lr, gr, cr = reference_steps(mc, seed, device,
                                 1 + int(run.mix["steps_per_call"]),
                                 run.batch, run.seq)
    found = gaps(losses, lr, grad_norms, gr, change, cr)
    limits = run.workload["limits"]
    for name, value in found.items():
        if name in limits:
            run.checks[name] = {"value": value,
                                "limit": float(limits[name])}
        else:
            run.info[name] = value
    run.info.update(losses=losses, reference_losses=lr,
                    reference_s=time.perf_counter() - t)
    free(device)
