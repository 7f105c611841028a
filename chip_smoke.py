"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the serving path from this checkout's
sources, holds each against its plain PyTorch version on the card at
the shapes the serving mixed step gives it, then serves the
full-width causal LM of the README (vocab 32000, 512 positions, hidden
512, 8 heads, 6 layers, ff 2048, f32, random weights from a numpy seed)
through ``ServeEngine.generate`` and holds its greedy tokens against
the no-cache ``generate_reference``. Every phase raises on failure.

Prints the card (name, power limit), the build time, each kernel's
error and times, the serving counters, then one line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without CUDA or outside a checkout.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): the HBM rate, and the
# operation rate for each input type — f32 outside the tensor cores,
# bf16 on them
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}

# the serving mixed step's geometry at the FFConfig defaults:
# serve_prefill_budget 512 + serve_max_seqs 8 lanes, kv_page_size 16,
# kv_num_pages 257, max_seq_len 512 -> 32 pages per sequence
T_PREFILL, MAX_SEQS, PAGE, PAGES_PER_SEQ, NUM_PAGES = 512, 8, 16, 32, 257
HEADS, HEAD_DIM = 8, 64

F32_TOL = 1e-5       # f32 pages: kernel vs single-pass plain version
BF16_TOL = 2e-2      # bf16 q and pages, output rounded to bf16
PARITY_MARGIN = 1e-3  # tie rule vs generate_reference (online softmax)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, timed with CUDA events
    around each call, after `warmup` calls. Before each call a 128 MiB
    write evicts the 50 MB L2, so every call starts cold, as attention
    does in a serving step (a whole step of other work runs between two
    launches on one layer's pages)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def kernel_inputs(dtype, device, seed=0):
    """The mixed step's attention inputs: one sequence's 512-token
    prefill chunk (slot 0, lanes at positions 0..511) plus 8 decode
    lanes (slots 0..7) at lengths spread over 1..512, on page tables
    that map the whole 256-page pool in a shuffled order."""
    rng = np.random.default_rng(seed)
    shape = (NUM_PAGES, PAGE, HEADS, HEAD_DIM)
    kp = torch.from_numpy(rng.standard_normal(shape, np.float32))
    vp = torch.from_numpy(rng.standard_normal(shape, np.float32))
    tables = rng.permutation(np.arange(1, NUM_PAGES)).reshape(
        MAX_SEQS, PAGES_PER_SEQ).astype(np.int32)
    t = T_PREFILL + MAX_SEQS
    q = torch.from_numpy(rng.standard_normal((t, HEADS, HEAD_DIM),
                                             np.float32))
    slots = np.concatenate([np.zeros(T_PREFILL, np.int32),
                            np.arange(MAX_SEQS, dtype=np.int32)])
    lens = np.concatenate([
        np.arange(1, T_PREFILL + 1, dtype=np.int32),
        np.linspace(1, PAGE * PAGES_PER_SEQ, MAX_SEQS).astype(np.int32)])
    put = lambda a: torch.as_tensor(a).to(device)   # noqa: E731
    return (put(q).to(dtype), put(kp).to(dtype), put(vp).to(dtype),
            put(tables), put(slots), put(lens))


def attention_bound(q, kp, tables, slots, lens):
    """(bound_ms, bound_by) of ragged paged attention on these inputs:
    the larger of the bytes it must move (each live K/V page — the pages
    below ceil(len/ps) of every lane's row — read once, q and the table
    data read once, the output written once) over the HBM rate, and its
    flops (q.k and p.v: 4 * len * H * D per lane) over the card's peak
    rate for the pages' type."""
    t_np, s_np, l_np = (tables.cpu().numpy(), slots.cpu().numpy(),
                        lens.cpu().numpy())
    live = set()
    for s, n in zip(s_np, l_np):
        live.update(int(p) for p in t_np[s, :-(-int(n) // PAGE)])
    page_bytes = PAGE * HEADS * HEAD_DIM * kp.element_size()
    nbytes = (2 * len(live) * page_bytes + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + slots.numel() * 4 + lens.numel() * 4)
    flops = 4.0 * float(l_np.astype(np.int64).sum()) * HEADS * HEAD_DIM
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[kp.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(pr):
    """Hold the CUDA kernel against ragged_attention_ref on the card in
    f32 and bf16; time the kernel and the plain version."""
    dev = torch.device("cuda")
    scale = 1.0 / math.sqrt(HEAD_DIM)
    res = {}
    for name, dtype, tol in (("f32", torch.float32, F32_TOL),
                             ("bf16", torch.bfloat16, BF16_TOL)):
        args = kernel_inputs(dtype, dev)
        out = pr.paged_ragged_v2_cuda(*args, scale)
        torch.cuda.synchronize()
        ref = pr.ragged_attention_ref(*args, scale)
        err = float((out.float() - ref.float()).abs().max())
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(
                f"paged_ragged_v2 {name}: max abs err {err} > {tol}")
        k_ms = cuda_ms(lambda: pr.paged_ragged_v2_cuda(*args, scale), 50)
        p_ms = cuda_ms(lambda: pr.ragged_attention_ref(*args, scale), 5)
        bound_ms, bound_by = attention_bound(args[0], args[1], *args[3:])
        res[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"kernel paged_ragged_v2 [{name} pages, T=520 H=8 D=64 ps=16 "
            f"pp=32 P=257]: max_abs_err={err:.3g} (tol {tol}) "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by})")
    log("library_ms: null — no single PyTorch call computes attention "
        "through a page table")
    return res


def serve_prompts(vocab, seed=0):
    """8 greedy prompts of 64..448 tokens — four share a 128-token
    preamble, one repeats a 16-token phrase (speculation accepts
    drafts there) — plus one 128-token prompt sampled at temperature
    0.8, top_k 8."""
    rng = np.random.default_rng(seed)
    rand = lambda n: [int(x) for x in rng.integers(1, vocab, n)]  # noqa
    pre = rand(128)
    greedy = [rand(64), rand(16) * 6, pre + rand(32), rand(224),
              pre + rand(160), rand(352), pre + rand(288), pre + rand(320)]
    return greedy, rand(128)


def serve_phase(pr, card: str):
    """Serve the full-width LM on the card; returns the kernel launches
    of the run and its stats."""
    from flexflow_tpu_torch import FFConfig, build_transformer_lm
    from flexflow_tpu_torch.serve import ServeEngine
    cfg = FFConfig()   # kv_page_size 16, kv_num_pages 257, 8 seqs, 512
    t0 = time.perf_counter()
    lm = build_transformer_lm(cfg, vocab_size=32000, max_seq_len=512,
                              hidden=512, num_heads=8, num_layers=6,
                              ff_dim=2048, seed=0, device="cuda")
    nparams = sum(p.numel() for p in lm.parameters())
    eng = ServeEngine(lm, cfg, device="cuda")
    boot = eng.warmup()
    log(f"serve: LM {nparams / 1e6:.1f} M params f32, KV pool "
        f"{eng.cache_cfg.pool_bytes / 2**20:.1f} MiB, built in "
        f"{time.perf_counter() - t0:.2f} s, warmup {boot['boot_s']:.3f} s")
    greedy, sampled = serve_prompts(32000)
    prompts = greedy + [sampled]
    new = 32
    pr.launches = 0                           # count the main path only
    out = eng.generate(prompts, new,
                       temperature=[None] * len(greedy) + [0.8],
                       top_k=[None] * len(greedy) + [8], sample_seed=7)
    launches = pr.launches
    st = eng.last_stats
    if [len(o) for o in out] != [new] * len(prompts):
        raise AssertionError(f"wrong output lengths {[len(o) for o in out]}")
    if not all(0 <= t < 32000 for o in out for t in o):
        raise AssertionError("token outside the vocabulary")
    if launches != eng.num_layers * st["steps"]:
        raise AssertionError(
            f"kernel launches {launches} != layers {eng.num_layers} x "
            f"steps {st['steps']}")
    ref = eng.generate_reference(greedy, new)
    exact = eng.assert_token_parity(greedy, out[:len(greedy)], ref,
                                    margin=PARITY_MARGIN)
    pre_lanes = sum(n for n, _ in st["prefill_times_s"])
    pre_s = sum(s for _, s in st["prefill_times_s"])
    dec_ms = 1e3 * float(np.mean(st["decode_step_times_s"]))
    log(f"serve [{card}]: steps={st['steps']} kernel_launches={launches} "
        f"(= {eng.num_layers} layers x steps) prefix_hit_tokens="
        f"{st['prefix_hit_tokens']} preemptions={st['preemptions']} "
        f"spec accepted/drafted={st['spec_accepted_tokens']}/"
        f"{st['spec_drafted_tokens']} greedy token-identical to reference: "
        f"{exact}/{len(greedy)} (rest diverge at a tie <= {PARITY_MARGIN})")
    log(f"serve [{card}]: decode step ms mean={dec_ms:.3f} over "
        f"{st['decode_steps']} steps; prefill tokens/s="
        f"{pre_lanes / pre_s:.1f}; output tokens/s="
        f"{st['tokens_per_sec']:.1f} ({st['total_new_tokens']} tokens in "
        f"{st['wall_s']:.3f} s)")
    return launches, st


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import flexflow_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 3
    if Path(flexflow_tpu_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: flexflow_tpu_torch is not this checkout's",
              file=sys.stderr)
        return 3
    from flexflow_tpu_torch.kernels import _build
    from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    for stale in _build.BUILD_DIR.glob("*.so"):
        stale.unlink()              # build from this checkout's sources
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    log(f"build: {', '.join(logs)} with nvcc {' '.join(_build.NVCC_FLAGS)}"
        f" in {secs:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    kres = kernel_phase(pr)
    launches, _ = serve_phase(pr, card)

    f32 = kres["f32"]
    log(json.dumps({"kernels": [{
        "name": "paged_ragged_v2", "route": "cuda",
        "source": "flexflow_tpu_torch/kernels/csrc/paged_ragged_v2.cu",
        "replaces": "flexflow_tpu/kernels/paged_ragged_v2.py:245",
        "launches": launches, "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": None,
        "bf16": kres["bf16"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
