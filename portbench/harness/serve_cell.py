"""A serving cell: OPT through ``ServeEngine`` and ``ServeSession``.

Set-up builds the model with ``build_transformer_lm``, compiles it for
inference, writes the seed's weights into its parameter tensors, builds
the engine and runs ``warmup`` (which builds the kernels and captures
the one mixed step: the only shape the loop uses). The closed loop then
runs the mix's ``ramp_steps`` steps, so that the window opens on a
filled pool with requests at every stage, and is timed from there for
``--seconds``: ``ServeSession.step`` over and over, each client sending
its next request as soon as its last one finished. The benchmark
stamps every token when the step that emitted it returns, as its
client would see it.

After the window the engine is freed and the plain reference judges a
sample of the requests finished in the window, drawn from the seed with
the longest among them: by how much the reference's logit of each
served token lies below the reference's best at that position.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from . import weights
from .closed_loop import RequestPool
from .record import Request, Run, Step
from .trace import Profiler, reduce, span
from ..reference import opt as ref

_DTYPES = ("compute_dtype", "param_dtype")


def ff_config(ft, settings: dict, **extra):
    """An FFConfig of the configuration file's program settings."""
    kw = {k: (getattr(torch, v) if k in _DTYPES else v)
          for k, v in settings.items()}
    kw.update(extra)
    return ft.FFConfig(**kw)


def build_model(ft, mc: dict, cfg, batch: int, seq: int, device):
    return ft.build_transformer_lm(
        cfg, vocab_size=mc["vocab_size"], max_seq_len=seq,
        batch_size=batch, hidden=mc["hidden_size"],
        num_heads=mc["num_attention_heads"],
        num_layers=mc["num_hidden_layers"], ff_dim=mc["ffn_dim"],
        device=device)


class Loop:
    """The closed loop over one ServeSession."""

    def __init__(self, sess, pool: RequestPool, run: Run, page_size: int,
                 traced: bool):
        self.sess = sess
        self.pool = pool
        self.run = run
        self.ps = page_size
        self.traced = traced
        self.live: Dict[int, tuple] = {}     # rid -> (program req, record)

    def send(self) -> None:
        prompt, out = self.pool.take()
        with span("serve.submit", self.traced):
            t = time.perf_counter()
            req = self.sess.submit(prompt, out)
        rec = Request(t_send=t, prompt=prompt)
        self.run.requests.append(rec)
        self.live[req.rid] = (req, rec)

    def _done(self, req, rec: Request, t: float) -> None:
        rec.t_done = t
        rec.outcome = req.outcome
        rec.tokens = list(req.out_tokens)
        del self.live[req.rid]
        self.send()

    def step(self, in_window: bool, traced: bool) -> Step:
        t0 = time.perf_counter()
        with span("serve.step", traced):
            ev = self.sess.step()
        t1 = time.perf_counter()
        if ev is None:
            raise RuntimeError("the closed loop drained: no request left")
        lanes = lens = pages = 0
        for ch in ev.plan.chunks:
            lanes += ch.end - ch.start
            lens += (ch.end * (ch.end + 1) - ch.start * (ch.start + 1)) // 2
            pages += -(-ch.end // self.ps)
        for r in ev.plan.admitted:
            rec = self.live[r.rid][1]
            if rec.t_admit is None:
                rec.t_admit = t0
        emitted = 0
        for req, n in ev.emitted:
            rec = self.live[req.rid][1]
            if rec.t_first is None:
                rec.t_first = t1
            rec.t_last = t1
            rec.n_out += n
            emitted += n
        for req in ev.finished:
            self._done(req, self.live[req.rid][1], t1)
        for req, rec in list(self.live.values()):
            if req.outcome not in ("pending", "completed"):
                self._done(req, rec, t1)     # failed, rejected, expired
        st = Step(t0, t1, lanes, lens, pages, emitted, in_window, traced)
        self.run.steps.append(st)
        return st


def build(run: Run, device, cache_dir):
    """(model, FFConfig) of the cell: the program's model compiled for
    inference, with the configuration file's settings."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.config import CompMode

    mc = run.config
    cfg = ff_config(ft, mc["program"], program_cache_dir=cache_dir)
    model = build_model(ft, mc, cfg, 1, mc["max_position_embeddings"],
                        device)
    model.compile(comp_mode=CompMode.INFERENCE)
    return model, cfg


def serve(run: Run, model, cfg, device, seed: int, seconds: float,
          traced: bool, t_start: float) -> dict:
    """Write the seed's weights into ``model``, build and warm up the
    engine, ramp the closed loop and measure the window (``traced``:
    a sub-window under the profiler); fills ``run`` and closes the
    engine. Returns the device facts read when the window closed."""
    from flexflow_tpu_torch.serve import ServeEngine

    mc, mix = run.config, run.mix
    weights.load_into(model.state.params, mc, seed)
    eng = ServeEngine(model, cfg, device=device)
    eng.warmup()
    run.mixed_width = eng.mixed_width
    prof = Profiler() if traced else None
    if prof is not None:
        prof.warm(device)
    sess = eng.start_session()
    loop = Loop(sess, RequestPool(mix, seed, mc["vocab_size"]), run,
                int(cfg.kv_page_size), traced)
    for _ in range(int(mix["clients"])):
        loop.send()
    for _ in range(int(mix["ramp_steps"])):
        loop.step(False, False)
    run.w0 = time.perf_counter()
    run.setup_s = run.w0 - t_start
    end = run.w0 + seconds
    trace_s = min(float(mix.get("trace_seconds", seconds)), seconds)
    tr0 = run.w0 + 0.5 * (seconds - trace_s)
    tracing, traced_prof = False, None
    last = None
    while time.perf_counter() < end:
        if prof is not None and traced_prof is None and not tracing \
                and time.perf_counter() >= tr0:
            prof.start()
            tracing, tr_start = True, time.perf_counter()
        last = loop.step(True, tracing)
        if tracing and last.t1 - tr_start >= trace_s:
            traced_prof, tracing = prof.stop(), False
    if tracing:
        traced_prof = prof.stop()
    run.w1 = last.t1
    facts = device_facts(device)
    if traced_prof is not None:
        run.trace = reduce(traced_prof)
        del traced_prof
        if run.trace is not None:
            run.info["device_s_by_class"] = run.trace.by_class
    for rec in run.requests:
        if run.in_window(rec.t_done):
            run.attempted += 1
            run.failed += rec.outcome != "completed"
    sess.close()
    eng.close()
    return facts


def run_serve(run: Run, device, seed: int, seconds: float, traced: bool,
              t_start: float, cache_dir) -> dict:
    """Set up, measure, free and judge one serving run; fills ``run``.
    Returns the device facts read when the window closed."""
    model, cfg = build(run, device, cache_dir)
    facts = serve(run, model, cfg, device, seed, seconds, traced, t_start)
    del model
    free(device)
    judge(run, device, seed)
    return facts


def device_facts(device) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"memory_peak_bytes": 0}
    torch.cuda.synchronize(dev)
    return {"memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sample(run: Run, seed: int, target: int) -> List[Request]:
    """Requests finished in the window, drawn from the seed: the longest
    first, then others until ``target`` served tokens."""
    done = [r for r in run.requests
            if run.in_window(r.t_done) and r.outcome == "completed"]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].tokens))
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0xC4EC])
    picked, total = [done[longest]], len(done[longest].tokens)
    for i in rng.permutation(len(done)):
        if total >= target:
            break
        if i != longest:
            picked.append(done[i])
            total += len(done[i].tokens)
    return picked


def served_gap(w, mc, reqs: List[Request], mm=ref.f32_matmul) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's best (with ``mm`` another product: the gap of the tokens
    that product puts first)."""
    worst = 0.0
    for r in reqs:
        gaps, low = ref.served_gaps(w, mc, r.prompt, r.tokens, mm=mm)
        worst = max(worst, max(gaps if mm is ref.f32_matmul else low))
    return worst


def stored_dtype(mc: dict):
    """The dtype the program stores the configuration's weights in."""
    return getattr(torch, mc["program"].get("param_dtype", "float32"))


def judge(run: Run, device, seed: int) -> None:
    """The reference's reading of this run's served tokens, beside each
    limit of the cell."""
    mc = run.config
    reqs = sample(run, seed, int(run.mix.get("check_tokens", 1024)))
    limit = float(run.workload["limits"]["served_logit_gap"])
    if not reqs:
        run.checks["served_logit_gap"] = {"value": None, "limit": limit}
        return
    ref.exact()
    w = weights.make_tree(mc, seed, device, stored_dtype=stored_dtype(mc))
    t = time.perf_counter()
    gap = served_gap(w, mc, reqs)
    run.checks["served_logit_gap"] = {"value": gap, "limit": limit}
    run.info.update(requests=len(reqs),
                    tokens=sum(len(r.tokens) for r in reqs),
                    reference_s=time.perf_counter() - t)
    del w
    free(device)
