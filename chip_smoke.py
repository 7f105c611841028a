"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from this checkout's sources (one
nvcc per source, in parallel), counts the tensor-core (HMMA)
instructions of each kernel in the built SASS — the bf16 paths of the
flash forward and backward and of the LSTM forward and backward must
have them; the bf16 flash backward at d=64, the LSTM forward step, the
ragged kernel's query-tile kernels and the decode kernels (split and
wide-head) must not spill — and then:

  * holds the ragged paged-attention kernel against its plain PyTorch
    version at the serving mixed step's shapes, on f32, bf16, int8 and
    fp8 pages, in the step's lane order and shuffled (timed in both);
    the paged decode kernel against its plain version at the
    legacy decode step's shapes (8 sequences over the same pool) and at
    one row of 512 keys and 8 rows of 4096, timed beside their bounds;
    and the v1 ragged kernel against its plain version and against v2
    at the mixed step's shapes, through its entry point, with the bytes
    its lanes re-read;
  * holds the three flash-attention kernels (forward, dq, dkv) against
    their plain pieces at the training paths' shapes (the encoder's
    b=32, s=512, h=8, d=64, causal and not, and the LM's b=16 causal,
    f32 and bf16) and at one odd shape (sq=300, sk=453), and times them
    beside scaled_dot_product_attention, interleaved in 3 rounds
    (median and range reported);
  * holds kernels 1-6 at head dims the kernels are not instantiated for
    (flash at d=16, 96, 256 on b=2 sq=300 sk=453 h=3, f32 and bf16,
    causal and not; the paged kernels at d=8, 96, 256, 320, 640 and at
    40 heads on a small pool, kernel 1 on all four page types) against
    their plain versions, and
    checks that the attention op at d=512 takes attention_ref;
  * trains the full-width Transformer encoder of ``build_transformer``
    (batch 32, seq 512, hidden 512, 8 heads, 6 layers, ff 2048, 10
    classes, SGD lr 0.01, weights and data from numpy seeds): 3 f32
    steps through the kernels against 3 on the einsum path, then the
    bf16 flagship — 3 steps held against the einsum path, 20 timed —
    with the kernels' launch counts checked;
  * trains the full-width causal LM of ``build_transformer_lm`` (the
    README's: vocab 32000, 512 positions, hidden 512, 8 heads, 6
    layers, ff 2048, ~52 M parameters) at batch 16 x 512 tokens on
    next-token labels from a numpy seed, SGD lr 0.01 momentum 0.9: 3
    f32 steps through the flash kernels (causal) against 3 on the
    einsum path; then under compute_dtype bfloat16 over f32 masters
    (every master and slot checked f32) 3 steps held against the
    einsum path, and the same model eagerly and with its train step
    captured as a CUDA graph, 3 held + 20 timed steps each: the
    captured weights and losses equal the eager ones bit for bit, one
    capture, the flash launches 6 layers x steps (a replay counts each
    launch of its graph);
  * holds the two LSTM kernels (forward, backward) against their plain
    versions at the NMT model's shapes (T=40, B=256, H=1024, f32 and
    bf16) and at one odd shape (T=3, B=70, H=100), timed beside
    torch.nn.LSTM (cuDNN: its forward, its backward alone, its forward
    + backward) as a yardstick, interleaved in 3 rounds;
  * trains the full-width NMT LSTM of ``build_nmt_lstm`` (batch 256,
    seq 40, vocab 32000, embed and hidden 1024, 2 layers, SGD lr 0.01,
    weights and data from numpy seeds): in f32 and in bf16, 3 steps
    through the kernels against 3 on the scan cell, every weight's
    gradient held between the two, and 3 with a planted dwh fault that
    the same check must reject; then 20 timed bf16 steps, with the
    kernels' launch counts and the device kernels they enqueued checked;
  * serves the f32 LM that phase trained (the FFModel's live
    parameters) through ``ServeEngine.generate`` four times — the mixed
    step on f32 pages, on int8 pages and on fp8 pages, and the legacy
    bucket path on f32 pages — every step replayed from the graph
    ``warmup`` captured: each run's captures are the path's families
    after warmup and unchanged after generate, its greedy tokens hold
    against one no-cache ``generate_reference``, all its tokens equal
    an eager engine's run token for token, and its kernel launches
    equal layers x steps; step times and tokens/s captured and eager;
  * trains the same LM with dropout 0.1 on each attention op and a
    Dropout(0.1) after each FFN (``dropout_lm_graph``; bf16 policy,
    batch 16 x 512) through ``fit``: (a) prefetch on against off, 3
    epochs of 8 steps, masters bit for bit, step wall, device ms and
    idle share of each, and the dropout and flash launches of the
    prefetch run counted from 0; (b) steps_per_dispatch=4 against 1, bit
    for bit, one train_step_multi capture; (c) grad_accum_steps=4 on
    microbatches of 4 x 512, captured against eager, bit for bit; (d)
    remat against off, bit for bit, the flash forward launched twice a
    layer a step, peak memory of both; (e) 2 epochs x 4 steps with a
    checkpoint directory, killed at train.dispatch in epoch 1 and run
    again, equal to an uninterrupted run bit for bit, and the save time;
  * (f) holds the dropout kernel against its plain version bit for bit
    (f32 and bf16, forward and backward, 16 x 512 x 512 and 3 x 1001 x
    77), timed beside its bound and torch.nn.functional.dropout (the
    same work on another random stream);
  * trains the conv and MLP sweep and the seq2seq (``SWEEP``) at the
    widths their users run — AlexNet b=256 on 3x32x32 bf16, Inception-v3
    b=32 on 3x299x299 bf16, ResNet-50 b=32 on 3x224x224 (1000 classes)
    under the bf16 policy, CANDLE-Uno b=64 f32, ``build_nmt_seq2seq`` at
    its defaults b=64 bf16 — with cuDNN deterministic and not autotuned:
    one f32 step on the card against the port's CPU step (batch 4, the
    same weights and batch), NHWC and sibling fusion off against the
    default, 3 captured steps equal to 3 eager ones bit for bit (losses,
    weights, running statistics), then 3 windows of 20 captured steps
    (step ms, samples/s, MFU, peak memory); for the seq2seq also the
    LSTM kernels against their plain versions at T=20, B=64, H=512, 3
    steps through them against 3 on the scan cell, and their launches on
    its main path (``seq2seq_launches`` in the lstm rows).

Every phase raises on failure. Prints the card (name, power limit), the
build, each kernel's error and times, the training and serving numbers,
the script's wall time, then one line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without CUDA or outside a checkout. Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): the HBM rate, and the
# operation rate for each input type — f32 outside the tensor cores,
# bf16 on them; int32 outside the tensor cores, from the same sheet: its
# f32 rate is 132 SMs x 128 lanes x 2 (an FMA) x 1.98 GHz, and an SM has
# 64 INT32 lanes, one operation a clock each
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
               torch.int8: 1979e12, torch.float8_e4m3fn: 1979e12,
               torch.int32: 132 * 64 * 1.98e9}
# the dropout kernel's 32-bit integer operations an element: threefry2x32
# (2 initial adds, 20 rounds of add, rotate and xor, 5 key injections of
# two adds) and the uniform's xor, shift and or; the op key's fold-in
# (one more threefry, 72) is counted once a call
DROPOUT_INT_OPS_PER_ELEMENT = 2 + 20 * 3 + 5 * 2 + 3
DROPOUT_INT_OPS_PER_CALL = 72

# the serving mixed step's geometry at the FFConfig defaults:
# serve_prefill_budget 512 + serve_max_seqs 8 lanes, kv_page_size 16,
# kv_num_pages 257, max_seq_len 512 -> 32 pages per sequence
T_PREFILL, MAX_SEQS, PAGE, PAGES_PER_SEQ, NUM_PAGES = 512, 8, 16, 32, 257
HEADS, HEAD_DIM = 8, 64

F32_TOL = 1e-5       # f32 pages: kernel vs single-pass plain version
BF16_TOL = 2e-2      # bf16 q and pages, output rounded to bf16
# int8/fp8 pages, as max abs error / max |plain|: kernel and plain
# version dequantize to the same f32 keys, so only the order of the
# sums differs
QUANT_REL_TOL = 1e-5
PARITY_MARGIN = 1e-3  # tie rule vs generate_reference (online softmax)

# the training path: the flagship encoder's attention shapes
TB, TS, TH, TD = 32, 512, 8, 64
# flash kernels vs their plain pieces, max abs error / max |ref|: f32
# differs in summation order only, bf16 where p and ds round
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# full-width training: kernel path vs einsum path. The attention
# outputs of the two paths differ by ~1e-7 (relative) in f32; through
# the unnormalized flagship's large activations a few ReLU inputs that
# lie within that of 0 flip, and each flip moves one column of an ff1
# gradient by |x * dy|: 1.3e-4 of weight after 3 steps on an H100
# (layer0_ff1.kernel, whose update was 4.4e-3), so the weight limit is
# 5e-4
TRAIN_F32_LOSS_REL = 1e-4
TRAIN_F32_WEIGHT_ABS = 5e-4
TRAIN_BF16_LOSS_REL = 2e-2
TRAIN_ARCH = dict(seq_len=TS, hidden=512, num_heads=TH, num_layers=6,
                  ff_dim=2048, num_classes=10)

# the causal LM of the README at full width (vocab 32000, 512
# positions, hidden 512, 8 heads, 6 layers, ff 2048: ~52 M parameters),
# trained at batch 16 x 512 tokens on next-token labels, SGD lr 0.01
# with momentum 0.9 (so the optimizer has slots to check)
LB = 16
LM_ARCH = dict(vocab_size=32000, max_seq_len=TS, hidden=512, num_heads=TH,
               num_layers=6, ff_dim=2048)
# kernel path vs einsum path, 3 steps from one set of weights: the
# encoder's limits (the same f32 function summed in another order; bf16
# where the two paths round p and ds)
LM_F32_LOSS_REL = 1e-4
LM_F32_WEIGHT_ABS = 5e-4
LM_BF16_LOSS_REL = 2e-2
# captured against eager steps: the same kernels on the same inputs in
# the same order, so the weights after 3 steps must be bit for bit the
# same (tolerance 0)
LM_CAPTURE_WEIGHT_ABS = 0.0

# the NMT LSTM at bench.py's "full" preset: T=40 tokens of a batch of
# 256, vocab 32000, embed and hidden 1024, 2 layers
NT, NB, NH, NV, NL = 40, 256, 1024, 32000, 2
# LSTM kernels vs their plain versions, max abs error / max |plain|: f32
# differs in the order of the f32 sums (K = 1024 a step, T*B = 10240 for
# dwh); bf16 where ys and dxg round to bf16, and a rounding that flips
# moves the next step's product
LSTM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# full-width NMT training, kernel path vs the scan cell (use_pallas=
# False), 3 SGD steps from one set of weights on learnable labels (the
# first token). The loss (~10.37 = ln 32000) barely moves in 3 steps at
# lr 0.01, so it is a coarse check: f32 to 1e-5 relative (one function
# summed in another order, the kernels' f32 FMAs against cuBLAS's f32
# GEMM, TF32 off in both), bf16 to 2e-2 (the paths carry h and c at
# other precisions). The gradients carry the parity: each weight's
# gradient in each step, as |g_kernel - g_scan| / |g_scan| (L2 norms).
# Not the weights: an LSTM weight's 3-step update (|update| ~1.5e-6
# over 4 M entries) lies under the f32 spacing of the weights, so the
# updates differ by rounding alone (6e-4 in f32 on an H100). On an H100
# the gradients read 7e-7 in f32 (summation order) and 4e-3 in bf16 (the
# two carries); a planted fault — the backward's dwh summed over h_t
# where h_{t-1} belongs — reads 0.41 in both and must read above the
# limit. Each limit sits about a factor of 10 or more from both
NMT_F32_LOSS_REL = 1e-5
NMT_BF16_LOSS_REL = 2e-2
NMT_GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0].strip()


SPIN_CYCLES = 2_000_000      # ~1 ms at H100 clocks: longer than a launch


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, timed with CUDA events
    around each call, after `warmup` calls. Before each call a 128 MiB
    write evicts the 50 MB L2, so every call starts cold, as attention
    does in a serving step (a whole step of other work runs between two
    launches on one layer's pages); then a spin kernel holds the stream
    while the host enqueues the call, so the events time the card's
    work and not the wrapper's host time."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(nbytes: float, flops: float, dtype):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate
    and the operations over the card's peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    """(bound_ms, bound_by) of paged attention on these inputs: the
    larger of the bytes it must move (each live K/V page — the pages
    below ceil(len/ps) of every row's table row — read once with, for
    1-byte pages, its f32 scale rows; q and the table data read once,
    the output written once) over the HBM rate, and its flops (q.k and
    p.v: 4 * len * H * D per row) over the card's peak rate for the
    pages' type. ``slots`` None: row b reads table row b (decode)."""
    t_np, l_np = tables.cpu().numpy(), lens.cpu().numpy()
    s_np = np.arange(len(l_np)) if slots is None else slots.cpu().numpy()
    live = set()
    for s, n in zip(s_np, l_np):
        live.update(int(p) for p in t_np[s, :-(-int(n) // PAGE)])
    page_bytes = PAGE * HEADS * HEAD_DIM * kp.element_size()
    if kp.element_size() == 1:
        page_bytes += PAGE * HEADS * 4
    nbytes = (2 * len(live) * page_bytes + 2 * q.numel() * q.element_size()
              + tables.numel() * 4
              + (1 if slots is None else 2) * len(l_np) * 4)
    flops = 4.0 * float(l_np.astype(np.int64).sum()) * HEADS * HEAD_DIM
    return bound(nbytes, flops, kp.dtype)


def check_err(name, out, ref, tol, relative=False):
    """(max abs error, error / max |ref|) of a kernel against its plain
    version; raises past ``tol`` (on the relative error if asked)."""
    err = float((out.float() - ref.float()).abs().max())
    rel = err / float(ref.float().abs().max())
    if not (math.isfinite(err) and (rel if relative else err) <= tol):
        raise AssertionError(
            f"{name}: max abs err {err} (/ max |ref| {rel}) > {tol}")
    return err, rel


def kernel_phase(pr):
    """Hold the CUDA kernel against ragged_attention_ref on the card on
    f32, bf16, int8 and fp8 pages; time the kernel and the plain
    version; then hold and time the kernel on the same lanes shuffled
    (every query tile one lane, the layout that shares no page)."""
    dev = torch.device("cuda")
    scale = 1.0 / math.sqrt(HEAD_DIM)
    res = {}
    for name, dtype, tol in (("f32", torch.float32, F32_TOL),
                             ("bf16", torch.bfloat16, BF16_TOL),
                             ("int8", torch.int8, QUANT_REL_TOL),
                             ("fp8", torch.float8_e4m3fn, QUANT_REL_TOL)):
        quant = dtype in pr.QUANTIZED_DTYPES
        args = kernel_inputs(torch.float32 if quant else dtype, dev)
        kw = {}
        if quant:
            q, kp, vp, *rest = args
            kq, ks = pr.quantize_kv_rows(kp, dtype)
            vq, vs = pr.quantize_kv_rows(vp, dtype)
            args = (q, kq, vq, *rest)
            kw = {"k_scales": ks, "v_scales": vs}
        out = pr.paged_ragged_v2_cuda(*args, scale, **kw)
        torch.cuda.synchronize()
        ref = pr.ragged_attention_ref(*args, scale, **kw)
        err, rel = check_err(f"paged_ragged_v2 {name}", out, ref, tol,
                             relative=quant)
        k_ms = cuda_ms(lambda: pr.paged_ragged_v2_cuda(*args, scale, **kw),
                       50)
        p_ms = cuda_ms(lambda: pr.ragged_attention_ref(*args, scale, **kw),
                       5)
        bound_ms, bound_by = attention_bound(args[0], args[1], *args[3:])
        # the same lanes in a shuffled order: no two neighbours share a
        # slot's run, so every query tile holds one lane
        perm = torch.from_numpy(np.random.default_rng(1).permutation(
            args[0].shape[0])).to(dev)
        sargs = (args[0][perm].contiguous(), args[1], args[2], args[3],
                 args[4][perm].contiguous(), args[5][perm].contiguous())
        sout = pr.paged_ragged_v2_cuda(*sargs, scale, **kw)
        torch.cuda.synchronize()
        s_err, _ = check_err(f"paged_ragged_v2 {name} shuffled", sout,
                             ref[perm], tol, relative=quant)
        s_ms = cuda_ms(lambda: pr.paged_ragged_v2_cuda(*sargs, scale, **kw),
                       50)
        res[name] = {"max_abs_err": err, "err_over_max_ref": rel,
                     "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "shuffled": {"max_abs_err": s_err, "ms": s_ms}}
        log(f"kernel paged_ragged_v2 [{name} pages, T=520 H=8 D=64 ps=16 "
            f"pp=32 P=257]: max_abs_err={err:.3g} err/max|ref|={rel:.3g} "
            f"(tol {tol}{' relative' if quant else ''}) "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}); lanes shuffled: "
            f"max_abs_err={s_err:.3g} kernel_ms={s_ms:.4f}")
        del args, sargs, kw, out, sout, ref
    log("library_ms: null — no single PyTorch call computes attention "
        "through a page table")
    return res


# kernel-only shapes of the paged decode kernel, beside its bound: one
# row of 512 keys, and 8 rows of 4096 (256 pages of 16) — (name, rows,
# pages a row)
DECODE_SHAPES = (("B=1 n=512", 1, 32), ("B=8 n=4096", 8, 256))


def decode_inputs(dtype, device, rows, pp, seed=0):
    """Decode inputs at the serving widths (H=8, D=64, pages of 16):
    ``rows`` rows of ``pp`` pages each over a shuffled pool, every row
    at its full length."""
    rng = np.random.default_rng(seed)
    shape = (1 + rows * pp, PAGE, HEADS, HEAD_DIM)
    put = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
    kp = put(rng.standard_normal(shape, np.float32)).to(dtype)
    vp = put(rng.standard_normal(shape, np.float32)).to(dtype)
    tables = put(rng.permutation(np.arange(1, 1 + rows * pp)).reshape(
        rows, pp).astype(np.int32))
    q = put(rng.standard_normal((rows, HEADS, HEAD_DIM), np.float32)) \
        .to(dtype)
    lens = put(np.full(rows, PAGE * pp, np.int32))
    return q, kp, vp, tables, lens


def paged_decode_phase(fa):
    """Kernels 5 and 6 on the card, f32 and bf16 pages: the paged decode
    kernel at the legacy decode step's shapes (the 8 decode rows of
    kernel_inputs over the same pool: B=8, lengths 1..512, tables
    (8, 32)), and the v1 ragged kernel at the mixed step's shapes, each
    against its plain version and timed; the decode kernel also at
    DECODE_SHAPES beside their bounds; logged beside each, from the
    inputs, the split rule's choice and, for v1, the bytes of its
    per-lane row reads (each lane reads its own row's K/V, sum(lens) *
    H * D * itemsize * 2); then v1 against v2 on f32 pages through the v1
    entry point — the oracle run that is v1's path (its launches are
    counted there)."""
    from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr
    dev = torch.device("cuda")
    scale = 1.0 / math.sqrt(HEAD_DIM)
    res = {"paged_decode": {}, "paged_ragged_v1": {}}
    for name, dtype, tol in (("f32", torch.float32, F32_TOL),
                             ("bf16", torch.bfloat16, BF16_TOL)):
        q, kp, vp, tables, slots, lens = kernel_inputs(dtype, dev)
        dargs = (q[T_PREFILL:].contiguous(), kp, vp, tables,
                 lens[T_PREFILL:].contiguous())
        rargs = (q, kp, vp, tables, slots, lens)
        for kname, cuda_fn, ref_fn, args, shape in (
                ("paged_decode", fa.paged_decode_cuda, fa.paged_decode_ref,
                 dargs, "B=8 H=8 D=64 ps=16 pp=32 P=257"),
                ("paged_ragged_v1", fa.paged_ragged_v1_cuda,
                 fa.paged_ragged_v1_ref, rargs,
                 "T=520 H=8 D=64 ps=16 pp=32 P=257")):
            out = cuda_fn(*args, scale)
            torch.cuda.synchronize()
            ref = ref_fn(*args, scale)
            err, rel = check_err(f"{kname} {name}", out, ref, tol)
            k_ms = cuda_ms(lambda: cuda_fn(*args, scale), 50)
            p_ms = cuda_ms(lambda: ref_fn(*args, scale), 5)
            slots_of = None if kname == "paged_decode" else args[4]
            b_ms, b_by = attention_bound(args[0], args[1], args[3],
                                         slots_of, args[-1])
            res[kname][name] = {
                "max_abs_err": err, "err_over_max_ref": rel, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
            # derived from the inputs, not measured: the split rule's
            # choice, and the bytes of v1's per-lane row reads
            ks, nsplit = fa.decode_splits(
                args[0].shape[0], HEADS, PAGE * PAGES_PER_SEQ,
                fa._sm_count(dev.index))
            extra = ""
            if kname == "paged_ragged_v1":
                reread = (2 * float(args[-1].sum()) * HEADS * HEAD_DIM
                          * kp.element_size())
                extra = f" per-lane row reads={reread / 1e6:.1f} MB"
            log(f"kernel {kname} [{name} pages, {shape}]: max_abs_err="
                f"{err:.3g} err/max|ref|={rel:.3g} (tol {tol}) "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}); from the inputs: "
                f"splits={nsplit}x{ks} keys "
                f"ctas={args[0].shape[0] * HEADS * nsplit}{extra}")
            del out, ref
        del q, kp, vp, tables, slots, lens, dargs, rargs
        for sname, rows, pp in DECODE_SHAPES:
            args = decode_inputs(dtype, dev, rows, pp)
            out = fa.paged_decode_cuda(*args, scale)
            torch.cuda.synchronize()
            ref = fa.paged_decode_ref(*args, scale)
            err, _ = check_err(f"paged_decode {name} {sname}", out, ref, tol)
            k_ms = cuda_ms(lambda: fa.paged_decode_cuda(*args, scale), 50)
            p_ms = cuda_ms(lambda: fa.paged_decode_ref(*args, scale), 5)
            b_ms, b_by = attention_bound(args[0], args[1], args[3], None,
                                         args[4])
            ks, nsplit = fa.decode_splits(rows, HEADS, PAGE * pp,
                                          fa._sm_count(dev.index))
            res["paged_decode"][name].setdefault("shapes", {})[sname] = {
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"kernel paged_decode [{name} pages, {sname} H=8 D=64 "
                f"ps=16]: max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by}); from "
                f"the inputs: splits={nsplit}x{ks} keys")
            del args, out, ref
        torch.cuda.empty_cache()
        if name == "f32":
            rargs = kernel_inputs(dtype, dev)
            v2 = pr.paged_ragged_v2_cuda(*rargs, scale)
            fa.launches["paged_ragged_v1"] = 0     # v1's path only
            v1 = fa.paged_attention_ragged_v1(*rargs, scale=scale)
            res["v1_launches"] = fa.launches["paged_ragged_v1"]
            torch.cuda.synchronize()
            if res["v1_launches"] != 1:
                raise AssertionError(
                    f"paged_attention_ragged_v1 launched "
                    f"{res['v1_launches']} kernels, not 1")
            err, rel = check_err("paged_ragged_v1 vs v2 f32", v1, v2,
                                 F32_TOL)
            res["v1_vs_v2_max_abs_err"] = err
            log(f"kernel paged_ragged_v1 vs paged_ragged_v2 [f32 pages, "
                f"T=520]: max_abs_err={err:.3g} (tol {F32_TOL}); the v1 "
                f"entry point launched its kernel {res['v1_launches']} "
                f"time")
            del rargs, v1, v2
    log("library_ms: null — no single PyTorch call computes attention "
        "through a page table")
    return res


def flash_bounds(dtype, causal, b=TB):
    """{kernel: (bound_ms, bound_by)} of the three flash kernels at the
    training shapes, batch ``b``. Flops count the (query, key) pairs this run
    computes — all s^2 of them, or the s(s+1)/2 on or below the
    diagonal when causal — at 4d (forward: q.k, p.v), 6d (dq: q.k,
    do.v, ds.k) and 8d (dkv: also p^T.do, ds^T.q) per pair. Bytes read
    each input once and write each output once: (b, s, h, d) operands
    in the input type, lse and delta f32 (b, h, s)."""
    pairs = TS * (TS + 1) / 2 if causal else float(TS * TS)
    per = b * TH * TD * pairs
    op = b * TS * TH * TD * torch.tensor([], dtype=dtype).element_size()
    row = b * TH * TS * 4
    return {"flash_fwd": bound(4 * op + row, 4 * per, dtype),
            "flash_bwd_dq": bound(5 * op + 2 * row, 6 * per, dtype),
            "flash_bwd_dkv": bound(6 * op + 2 * row, 8 * per, dtype)}


def yardstick(fns, rounds=3, iters=10):
    """{name: [ms, one a round]}: each fn timed with cuda_ms in turn,
    `rounds` times, the order reversed every other round, so that a
    kernel and its library call are timed under the same card state in
    one call."""
    names, out = list(fns), {n: [] for n in fns}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n].append(cuda_ms(fns[n], iters))
    return out


def spread(xs):
    """'median (min-max)' of a yardstick's rounds."""
    return f"{statistics.median(xs):.4f} ({min(xs):.4f}-{max(xs):.4f})"


def sdpa_fns(q, k, v, do, causal):
    """library_ms yardsticks: torch's scaled_dot_product_attention
    forward on the same tensors, and its backward (one call computes
    dq, dk and dv). Timed here only; the port never calls it."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal)
    out = fwd()
    return fwd, lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                            retain_graph=True)


def flash_errors(fa, q, k, v, do, kw):
    """{kernel: (max abs error, error / max |plain|)} of the three flash
    kernels against their plain pieces on one input; raises past
    FLASH_TOL. The backward pieces run on the plain forward's o and
    lse. Returns the errors and the backward's inputs."""
    dtype = q.dtype
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **kw)
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    bargs = (q, k, v, do, lse_ref, delta)
    dq = fa.flash_bwd_dq_cuda(*bargs, **kw)
    dk, dv = fa.flash_bwd_dkv_cuda(*bargs, **kw)
    torch.cuda.synchronize()
    dq_ref = fa.flash_bwd_dq_ref(*bargs, **kw)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*bargs, **kw)
    errs = {}
    for kname, pairs in (
            ("flash_fwd", ((o, o_ref), (lse, lse_ref))),
            ("flash_bwd_dq", ((dq, dq_ref),)),
            ("flash_bwd_dkv", ((dk, dk_ref), (dv, dv_ref)))):
        abs_err = max(float((a.float() - r.float()).abs().max())
                      for a, r in pairs)
        rel = max(float((a.float() - r.float()).abs().max()
                        / r.float().abs().max()) for a, r in pairs)
        if not (math.isfinite(rel) and rel <= FLASH_TOL[dtype]):
            raise AssertionError(
                f"{kname} {dtype} {tuple(q.shape)} x {tuple(k.shape)} "
                f"causal={kw['causal']}: error / max |ref| {rel} > "
                f"{FLASH_TOL[dtype]}")
        errs[kname] = (abs_err, rel)
    return errs, bargs


def flash_phase(fa):
    """Hold flash_fwd, flash_bwd_dq and flash_bwd_dkv against their
    plain pieces on the card at the training shapes, f32 and bf16:
    the flagship encoder's (batch 32, causal and not) and the causal
    LM's (batch 16, causal), and at one odd shape whose sequence tails
    are masked; time each at the training shapes beside
    scaled_dot_product_attention, interleaved in 3 rounds."""
    dev = torch.device("cuda")
    scale = 1.0 / math.sqrt(TD)
    res = {}
    cells = [(t, c, TB, f"{d}{'_causal' if c else ''}")
             for d, t in (("f32", torch.float32), ("bf16", torch.bfloat16))
             for c in (False, True)]
    cells += [(t, True, LB, f"lm_{d}_causal")
              for d, t in (("f32", torch.float32), ("bf16", torch.bfloat16))]
    for dtype, causal, b, cell in cells:
        rng = np.random.default_rng(11)
        put = lambda a: torch.from_numpy(a).to(dev).to(dtype)  # noqa
        q, k, v, do = (put(rng.standard_normal((b, TS, TH, TD),
                                               np.float32))
                       for _ in range(4))
        kw = {"causal": causal, "scale": scale}
        errs, bargs = flash_errors(fa, q, k, v, do, kw)
        plain = {
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd_ref(q, k, v, **kw),
                                 3),
            "flash_bwd_dq": cuda_ms(
                lambda: fa.flash_bwd_dq_ref(*bargs, **kw), 3),
            "flash_bwd_dkv": cuda_ms(
                lambda: fa.flash_bwd_dkv_ref(*bargs, **kw), 3)}
        lib_fwd, lib_bwd = sdpa_fns(q, k, v, do, causal)
        rounds = yardstick({
            "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, **kw),
            "sdpa_fwd": lib_fwd,
            "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(*bargs, **kw),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(*bargs, **kw),
            "sdpa_bwd": lib_bwd})
        bounds = flash_bounds(dtype, causal, b)
        for kname in plain:
            b_ms, b_by = bounds[kname]
            lib = "sdpa_fwd" if kname == "flash_fwd" else "sdpa_bwd"
            ms = statistics.median(rounds[kname])
            lib_ms = statistics.median(rounds[lib])
            res.setdefault(kname, {})[cell] = {
                "max_abs_err": errs[kname][0],
                "err_over_max_ref": errs[kname][1],
                "ms": ms, "plain_ms": plain[kname],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "ms_rounds": rounds[kname],
                "library_ms_rounds": rounds[lib]}
            log(f"kernel {kname} [{cell}, b={b} s={TS} h={TH} "
                f"d={TD}]: max_abs_err={errs[kname][0]:.3g} "
                f"err/max|ref|={errs[kname][1]:.3g} (tol "
                f"{FLASH_TOL[dtype]}) kernel_ms={spread(rounds[kname])} "
                f"plain_ms={plain[kname]:.4f} bound_ms={b_ms:.4f} "
                f"({b_by}) library_ms={spread(rounds[lib])} "
                f"[median (min-max) of 3 interleaved rounds]")
        del q, k, v, do, bargs, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    # one odd shape: both sequence lengths off the tiles, sq != sk
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for causal in (False, True):
            rng = np.random.default_rng(12)
            q, do = (torch.from_numpy(rng.standard_normal(
                (3, 300, 5, TD), np.float32)).to(dev).to(dtype)
                for _ in range(2))
            k, v = (torch.from_numpy(rng.standard_normal(
                (3, 453, 5, TD), np.float32)).to(dev).to(dtype)
                for _ in range(2))
            errs, _ = flash_errors(fa, q, k, v, do,
                                   {"causal": causal, "scale": scale})
            cell = f"{dname}{'_causal' if causal else ''}"
            for kname, (abs_err, rel) in errs.items():
                res[kname].setdefault("odd_shape", {})[cell] = {
                    "shape": "b=3 sq=300 sk=453 h=5 d=64",
                    "max_abs_err": abs_err, "err_over_max_ref": rel}
            log(f"kernels flash_* [{cell}, b=3 sq=300 sk=453 h=5 d={TD}]: "
                f"err/max|ref| " + ", ".join(
                    f"{n} {e[1]:.3g}" for n, e in errs.items()) +
                f" (tol {FLASH_TOL[dtype]})")
    log("library_ms: flash_fwd = scaled_dot_product_attention forward; "
        "flash_bwd_dq and flash_bwd_dkv = its whole backward (dq, dk and "
        "dv in one call), timed once a round and reported on both rows")
    return res


def head_dim_phase(fa, pr):
    """Kernels 1-6 at head dims off their instantiations, on small
    shapes: the flash kernels at d=16, 96 (zero-padded to 32 and 128)
    and 256 (32-row CUDA-core tiles) on b=2 sq=300 sk=453 h=3, f32 and
    bf16, causal and not; kernel 1 on f32, bf16, int8 and fp8 pages and
    kernels 5 and 6 on f32 and bf16 pages at h=4 and d=8, 96, 256, 320
    and 640 (past 512: kernel 1's 8-key tiles, kernels 5 and 6's
    accumulators in shared memory), and at h=40 d=64; each against its
    plain version at its phase's tolerance.
    Then the attention op at d=512, past the flash kernels' 256, which
    must take attention_ref by its shape rule and launch no flash
    kernel. Returns {check: worst error / max |plain|}."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.op import OpContext
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    res = {}
    for d in (16, 96, 256):
        for dname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            for causal in (False, True):
                rng = np.random.default_rng(d)
                put = lambda s: torch.from_numpy(  # noqa: E731
                    rng.standard_normal(s, np.float32)).to(dev).to(dtype)
                q, do = put((2, 300, 3, d)), put((2, 300, 3, d))
                k, v = put((2, 453, 3, d)), put((2, 453, 3, d))
                errs, _ = flash_errors(fa, q, k, v, do, {
                    "causal": causal, "scale": 1.0 / math.sqrt(d)})
                for kname, (_, rel) in errs.items():
                    key = f"{kname} d={d} {dname}"
                    res[key] = max(res.get(key, 0.0), rel)
    rng = np.random.default_rng(21)
    for h, d in ((4, 8), (4, 96), (4, 256), (4, 320), (4, 640), (40, 64)):
        shape = (1 + 4 * 6, 16, h, d)
        kp = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)
        vp = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)
        tables = torch.from_numpy(rng.permutation(np.arange(1, 25))
                                  .reshape(4, 6).astype(np.int32)).to(dev)
        q = torch.from_numpy(rng.standard_normal((40, h, d), np.float32)) \
            .to(dev)
        slots = torch.from_numpy(rng.integers(0, 4, 40).astype(np.int32)) \
            .to(dev)
        lens = torch.from_numpy(rng.integers(1, 97, 40).astype(np.int32)) \
            .to(dev)
        scale = 1.0 / math.sqrt(d)
        for name, dtype, tol in (("f32", torch.float32, F32_TOL),
                                 ("bf16", torch.bfloat16, BF16_TOL),
                                 ("int8", torch.int8, QUANT_REL_TOL),
                                 ("fp8", torch.float8_e4m3fn,
                                  QUANT_REL_TOL)):
            quant = dtype in pr.QUANTIZED_DTYPES
            kw, qq = {}, q if quant else q.to(dtype)
            if quant:
                kq, ks = pr.quantize_kv_rows(kp, dtype)
                vq, vs = pr.quantize_kv_rows(vp, dtype)
                kw = {"k_scales": ks, "v_scales": vs}
            else:
                kq, vq = kp.to(dtype), vp.to(dtype)
            args = (qq, kq, vq, tables, slots, lens)
            checks = [("paged_ragged_v2", pr.paged_ragged_v2_cuda(
                *args, scale, **kw), pr.ragged_attention_ref(
                *args, scale, **kw))]
            if not quant:
                dargs = (qq[:4].contiguous(), kq, vq, tables,
                         lens[:4].contiguous())  # row b reads table row b
                checks += [
                    ("paged_decode", fa.paged_decode_cuda(*dargs, scale),
                     fa.paged_decode_ref(*dargs, scale)),
                    ("paged_ragged_v1", fa.paged_ragged_v1_cuda(
                        *args, scale), fa.paged_ragged_v1_ref(*args, scale))]
            torch.cuda.synchronize()
            cell = f"d={d}" if h == 4 else f"h={h} d={d}"
            for kname, out, ref in checks:
                _, rel = check_err(f"{kname} {name} {cell}", out, ref, tol,
                                   relative=quant)
                res[f"{kname} {cell} {name}"] = rel
    # the op past 256: attention_ref by the shape rule, no flash launch
    ff = FFModel(FFConfig(), device="cuda")
    x = ff.create_tensor((2, 64, 1024), name="x")
    ff.multihead_attention(x, x, x, 1024, 2, causal=True, name="mha")
    op = ff.ops[-1]
    params = {k: torch.from_numpy(rng.standard_normal(s.shape, np.float32)
                                  * 0.03).to(dev)
              for k, s in op.weight_specs().items()}
    xt = torch.from_numpy(rng.standard_normal((2, 64, 1024), np.float32)) \
        .to(dev)
    before = dict(fa.launches)
    y = op.forward(params, [xt, xt, xt], OpContext(training=False))[0]
    torch.cuda.synchronize()
    if fa.launches != before:
        raise AssertionError(f"the op at head_dim 512 launched a flash "
                             f"kernel: {fa.launches} (was {before})")
    op.use_flash = False
    want = op.forward(params, [xt, xt, xt], OpContext(training=False))[0]
    _, res["op d=512 vs attention_ref"] = check_err(
        "attention op d=512", y, want, 1e-6, relative=True)
    secs = time.perf_counter() - t0
    log(f"head_dim phase ({secs:.1f} s): error / max |plain| " + ", ".join(
        f"{k} {e:.3g}" for k, e in res.items()) + f"; tolerances flash "
        f"{FLASH_TOL[torch.float32]} f32 / {FLASH_TOL[torch.bfloat16]} "
        f"bf16, paged f32 {F32_TOL} and bf16 {BF16_TOL} absolute, int8/fp8 "
        f"{QUANT_REL_TOL}; the op at d=512 launched no flash kernel")
    return res


def train_batches(n, seed=0):
    """n host batches of the flagship: input randn(32, 512, 512) f32,
    labels randint(0, 10), from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [{"input": rng.standard_normal((TB, TS, 512), np.float32),
             "label": rng.integers(0, 10, TB).astype(np.int32)}
            for _ in range(n)]


def train_model(dtype, use_flash, capture=True):
    """The flagship at full width on the card, SGD lr 0.01; weights
    come from the port's numpy streams seeded by (config.seed, op,
    weight), so every model built here starts from the same weights.
    ``capture=False`` runs every step eagerly."""
    from flexflow_tpu_torch import FFConfig, SGDOptimizer, build_transformer
    m = build_transformer(FFConfig(batch_size=TB, seed=0), batch_size=TB,
                          dtype=dtype, use_flash=use_flash, device="cuda",
                          **TRAIN_ARCH)
    m.compile(optimizer=SGDOptimizer(lr=0.01),
              loss_type="sparse_categorical_crossentropy",
              metrics=["accuracy"], capture=capture)
    return m


def train_phase(fa, card: str):
    """(a) f32: 3 steps through the kernels vs 3 on the einsum path;
    (b) the bf16 flagship: 3 steps on the einsum path, then through the
    kernels 3 warm-up steps held against them and 20 timed steps, with
    the launch counts checked. Returns the launches of (b) and its
    numbers."""
    batches = train_batches(4)
    # (a) f32, kernel vs plain
    runs = {}
    for use_flash in (None, False):
        m = train_model(torch.float32, use_flash)
        if use_flash is None:
            nparams = sum(w.numel() for p in m.state.params.values()
                          for w in p.values())
        losses = [float(m.train_batch(batches[i])["loss"])
                  for i in range(3)]
        runs[use_flash] = (losses, {op: {k: w.detach().clone()
                                         for k, w in p.items()}
                                    for op, p in m.state.params.items()})
        del m
        torch.cuda.empty_cache()
    (lk, wk), (lp, wp) = runs[None], runs[False]
    if not all(abs(a - b) <= TRAIN_F32_LOSS_REL * abs(b)
               for a, b in zip(lk, lp)):
        raise AssertionError(f"f32 losses kernel {lk} vs plain {lp}")
    wdiff, worst = max((float((wk[op][k] - wp[op][k]).abs().max()),
                        f"{op}.{k}") for op in wk for k in wk[op])
    if not wdiff <= TRAIN_F32_WEIGHT_ABS:
        raise AssertionError(
            f"f32 weights differ by {wdiff} ({worst}) after 3 steps")
    log(f"train f32 [{card}]: {nparams / 1e6:.2f} M params; losses kernel "
        f"{[round(x, 6) for x in lk]} plain {[round(x, 6) for x in lp]}; "
        f"max |weight diff| after 3 steps {wdiff:.3g} at {worst} (tol "
        f"{TRAIN_F32_WEIGHT_ABS})")
    del runs, wk, wp

    # (b) the bf16 flagship
    m = train_model(torch.bfloat16, False)
    plain = [float(m.train_batch(batches[i])["loss"]) for i in range(3)]
    del m
    torch.cuda.empty_cache()
    m = train_model(torch.bfloat16, None)
    steps_warm, steps_timed = 3, 20
    torch.cuda.reset_peak_memory_stats()
    fa.launches.update(dict.fromkeys(fa.launches, 0))  # the main path only
    warm = [float(m.train_batch(batches[i])["loss"])
            for i in range(steps_warm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [m.train_batch(batches[i % len(batches)])
               for i in range(steps_timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fa.launches[k] for k in fa.FLASH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    timed = [float(x["loss"]) for x in metrics]
    want = 6 * (steps_warm + steps_timed)
    if launches != dict.fromkeys(launches, want):
        raise AssertionError(f"flash launches {launches} != 6 layers x "
                             f"{steps_warm + steps_timed} steps")
    if not all(math.isfinite(x) for x in warm + timed):
        raise AssertionError(f"non-finite loss in {warm + timed}")
    if not all(abs(a - b) <= TRAIN_BF16_LOSS_REL * abs(b)
               for a, b in zip(warm, plain)):
        raise AssertionError(f"bf16 losses kernel {warm} vs plain {plain}")
    step_ms = 1e3 * wall / steps_timed
    res = {"step_ms": step_ms, "samples_per_s": TB * steps_timed / wall,
           "peak_mem_gib": peak / 2**30, "launches": launches,
           "losses": warm + timed}
    log(f"train bf16 [{card}]: losses kernel {[round(x, 4) for x in warm]} "
        f"plain {[round(x, 4) for x in plain]} (tol rel "
        f"{TRAIN_BF16_LOSS_REL}); launches {launches} (= 6 layers x "
        f"{steps_warm + steps_timed} steps)")
    log(f"train bf16 [{card}]: step ms {step_ms:.3f} over {steps_timed} "
        f"steps, {res['samples_per_s']:.1f} samples/s, peak memory "
        f"{res['peak_mem_gib']:.2f} GiB, last loss {timed[-1]:.4f}")
    return res


def lm_batches(n, seed=0):
    """n host batches of the LM: tokens randint(0, 32000) of shape
    (16, 512), their positions, and next-token labels (the last
    position predicts the first token), from a numpy seed."""
    rng = np.random.default_rng(seed)
    pos = np.tile(np.arange(TS, dtype=np.int32), (LB, 1))
    out = []
    for _ in range(n):
        toks = rng.integers(0, LM_ARCH["vocab_size"], (LB, TS)) \
            .astype(np.int32)
        out.append({"tokens": toks, "positions": pos,
                    "label": np.roll(toks, -1, axis=1)})
    return out


def lm_model(compute_dtype, use_flash=True, capture=True):
    """The LM at full width on the card under ``compute_dtype``'s
    policy (f32 masters). Weights come from the port's numpy streams
    seeded by (config.seed, op, weight), so every model built here
    starts from the same weights. ``use_flash=False`` puts the attention
    ops on the einsum path; ``capture=False`` runs every step eagerly."""
    from functools import partial
    from flexflow_tpu_torch import FFConfig, SGDOptimizer, build_transformer_lm
    from flexflow_tpu_torch.core.losses import \
        sparse_categorical_crossentropy
    m = build_transformer_lm(
        FFConfig(batch_size=LB, seed=0, compute_dtype=compute_dtype),
        batch_size=LB, device="cuda", **LM_ARCH)
    if not use_flash:
        for op in m.ops:
            if op.name.endswith("_attn"):
                op.use_flash = False
    m.compile(optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
              loss_type=partial(sparse_categorical_crossentropy,
                                from_logits=True),
              metrics=[], capture=capture)
    return m


def weights_of(m):
    return {f"{op}.{k}": w.detach().clone()
            for op, p in m.state.params.items() for k, w in p.items()}


def max_weight_diff(a, b):
    return max((float((a[n].float() - b[n].float()).abs().max()), n)
               for n in a)


def check_masters(m, what):
    """Every master and optimizer slot stays f32 under the policy."""
    bad = [f"{op}.{k}" for tree in (m.state.params,
                                    *m.state.opt_state.values())
           for op, p in tree.items() for k, w in p.items()
           if w.dtype != torch.float32]
    if bad:
        raise AssertionError(f"{what}: masters or slots not f32: {bad}")


def release(m):
    """Drop a model's captured train step and cached memory."""
    m.executor.programs.release()
    gc.collect()
    torch.cuda.empty_cache()


def lm_train_phase(fa, card: str):
    """(a) f32: 3 steps through the flash kernels (captured) vs 3 on the
    einsum path; (b) compute_dtype bfloat16 over f32 masters: 3 einsum
    steps held against the kernels, every master and slot checked f32;
    then the same model eagerly and captured, 3 held steps each
    (weights equal to LM_CAPTURE_WEIGHT_ABS) and 20 timed, with the
    capture count and the flash launches (6 layers x steps, a replay
    counting each launch of its graph) checked. Returns its numbers and
    the f32 model trained through the kernels (served next)."""
    batches = lm_batches(4)
    t0 = time.perf_counter()
    runs, served = {}, None
    for use_flash in (True, False):
        m = lm_model("float32", use_flash)
        losses = [float(m.train_batch(batches[i])["loss"])
                  for i in range(3)]
        runs[use_flash] = (losses, weights_of(m))
        release(m)
        if use_flash:
            served = m
            nparams = sum(w.numel() for w in runs[True][1].values())
        del m
    (lk, wk), (lp, wp) = runs[True], runs[False]
    if not all(abs(a - b) <= LM_F32_LOSS_REL * abs(b)
               for a, b in zip(lk, lp)):
        raise AssertionError(f"LM f32 losses kernel {lk} vs plain {lp}")
    wdiff, worst = max_weight_diff(wk, wp)
    if not wdiff <= LM_F32_WEIGHT_ABS:
        raise AssertionError(
            f"LM f32 weights differ by {wdiff} ({worst}) after 3 steps")
    log(f"train lm f32 [{card}]: {nparams / 1e6:.2f} M params, batch {LB} "
        f"x {TS} tokens; losses kernel {[round(x, 6) for x in lk]} plain "
        f"{[round(x, 6) for x in lp]} (tol rel {LM_F32_LOSS_REL}); max "
        f"|weight diff| after 3 steps {wdiff:.3g} at {worst} (tol "
        f"{LM_F32_WEIGHT_ABS})")
    del runs, wk, wp

    m = lm_model("bfloat16", use_flash=False)
    plain = [float(m.train_batch(batches[i])["loss"]) for i in range(3)]
    check_masters(m, "LM bf16 einsum")
    release(m)
    del m
    steps_warm, steps_timed = 3, 20
    res = {"f32_losses_kernel": lk, "f32_losses_plain": lp,
           "f32_weight_diff": wdiff, "bf16_losses_plain": plain}
    held = None
    for mode in ("eager", "captured"):
        m = lm_model("bfloat16", capture=mode == "captured")
        torch.cuda.reset_peak_memory_stats()
        fa.launches.update(dict.fromkeys(fa.launches, 0))  # this run only
        warm = [float(m.train_batch(batches[i])["loss"])
                for i in range(steps_warm)]
        w3 = weights_of(m)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = [m.train_batch(batches[i % len(batches)])
                   for i in range(steps_timed)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        timed = [float(x["loss"]) for x in metrics]
        launches = {k: fa.launches[k] for k in fa.FLASH_KERNELS}
        steps, layers = steps_warm + steps_timed, LM_ARCH["num_layers"]
        if launches != dict.fromkeys(launches, layers * steps):
            raise AssertionError(f"LM bf16 {mode}: flash launches "
                                 f"{launches} != {layers} layers x {steps} "
                                 f"steps")
        counts = m.compile_counts()
        replays = m.executor.programs.replay_counts()
        want_replays = steps - 1 if mode == "captured" else 0
        if counts != {"train_step": 1} or \
                replays != {"train_step": want_replays}:
            raise AssertionError(f"LM bf16 {mode}: captures {counts}, "
                                 f"replays {replays}")
        check_masters(m, f"LM bf16 {mode}")
        if not all(math.isfinite(x) for x in warm + timed):
            raise AssertionError(f"LM bf16 {mode}: non-finite loss")
        if not all(abs(a - b) <= LM_BF16_LOSS_REL * abs(b)
                   for a, b in zip(warm, plain)):
            raise AssertionError(f"LM bf16 {mode}: losses kernel {warm} "
                                 f"vs plain {plain}")
        cell = {"step_ms": 1e3 * wall / steps_timed,
                "samples_per_s": LB * steps_timed / wall,
                "tokens_per_s": LB * TS * steps_timed / wall,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": launches, "compile_counts": counts,
                "replays": replays, "losses": warm + timed}
        if held is None:
            held = (warm + timed, w3)
        else:
            cdiff, cworst = max_weight_diff(w3, held[1])
            if not cdiff <= LM_CAPTURE_WEIGHT_ABS or \
                    warm + timed != held[0]:
                raise AssertionError(
                    f"LM bf16 captured steps differ from eager: weights "
                    f"by {cdiff} at {cworst}, losses {warm + timed} vs "
                    f"{held[0]}")
            cell["weight_diff_vs_eager"] = cdiff
        res[mode] = cell
        log(f"train lm bf16 {mode} [{card}]: losses kernel "
            f"{[round(x, 4) for x in warm]} plain "
            f"{[round(x, 4) for x in plain]} (tol rel {LM_BF16_LOSS_REL}); "
            f"launches {launches} (= {layers} layers x {steps} steps); "
            f"compile_counts {counts} replays {replays}; masters and "
            f"slots f32")
        log(f"train lm bf16 {mode} [{card}]: step ms "
            f"{cell['step_ms']:.3f} over {steps_timed} steps, "
            f"{cell['samples_per_s']:.1f} samples/s, "
            f"{cell['tokens_per_s']:.0f} tokens/s, peak memory "
            f"{cell['peak_mem_gib']:.2f} GiB, last loss {timed[-1]:.4f}")
        release(m)
        del m, metrics
    log(f"train lm bf16 [{card}]: captured steps equal eager ones after "
        f"3 steps (max |weight diff| {res['captured']['weight_diff_vs_eager']}"
        f", tol {LM_CAPTURE_WEIGHT_ABS}) and in all {steps} losses; "
        f"phase {time.perf_counter() - t0:.1f} s")
    return res, served


def lstm_inputs(dtype, seed=0):
    """Kernel 7's and 8's inputs at the NMT shapes: xg (T, B, 4H) at
    the scale of x.wx (~0.5), wh (H, 4H) at glorot's (~0.03), h0/c0
    (B, H) f32, dys (T, B, H) — from a numpy seed, on the card."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def put(shape, scale):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * scale).to(dev)
    return (put((NT, NB, 4 * NH), 0.5).to(dtype),
            put((NH, 4 * NH), 0.03).to(dtype), put((NB, NH), 0.3),
            put((NB, NH), 0.3), put((NT, NB, NH), 1.0).to(dtype))


def lstm_bounds(dtype):
    """{kernel: (bound_ms, bound_by)} of the two LSTM kernels. Flops:
    the forward's T products (B, H) x (H, 4H), 2*T*B*H*4H; the
    backward's three such (the gate recompute, dlin.wh^T, and dwh).
    Bytes: each input read once, each output written once — forward xg,
    wh, h0, c0 in, ys and cs out; backward xg, wh, h0, c0, ys, cs, dys
    in, dxg, dwh (f32), dh0, dc0 out."""
    e = torch.tensor([], dtype=dtype).element_size()
    tbh = NT * NB * NH
    flops = 2.0 * NT * NB * NH * 4 * NH
    state = 2 * NB * NH * 4
    fwd_bytes = (4 * tbh + 4 * NH * NH) * e + state + tbh * (e + 4)
    bwd_bytes = (fwd_bytes + tbh * e               # + dys
                 + 4 * tbh * e + 4 * NH * NH * 4 + state)
    return {"lstm_fwd": bound(fwd_bytes, flops, dtype),
            "lstm_bwd": bound(bwd_bytes, 3 * flops, dtype)}


def cudnn_fns(dtype):
    """library_ms yardsticks: torch.nn.LSTM (cuDNN, TF32 off) over
    x (T, B, D=H) as callables — its forward, its forward + backward,
    and its backward alone (``torch.autograd.grad`` on a forward
    computed once, outside the timed window, its graph retained). One
    call computes the whole layer, the input product x.wx included.
    Timed here only; the port never calls cuDNN. None, printing why,
    where the installed PyTorch refuses cuDNN for this dtype."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((NT, NB, NH), np.float32)) \
        .to(dev).to(dtype).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((NT, NB, NH), np.float32)) \
        .to(dev).to(dtype)
    try:
        net = torch.nn.LSTM(NH, NH).to(dev).to(dtype)
        net.flatten_parameters()     # one weight buffer, as cuDNN wants
        fwd = lambda: net(x)[0]                        # noqa: E731
        fwd_bwd = lambda: torch.autograd.grad(         # noqa: E731
            fwd(), [x, *net.parameters()], dy)
        fwd_bwd()
        y = fwd()
        bwd = lambda: torch.autograd.grad(             # noqa: E731
            y, [x, *net.parameters()], dy, retain_graph=True)
        bwd()
        torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"library_ms: torch.nn.LSTM refused {dtype}: {e}")
        return None
    return fwd, fwd_bwd, bwd


def port_layer_ms(dtype):
    """The port's own LSTM layer timed as cudnn_fns times cuDNN's: the
    LSTM op's forward (x.wx matmul plus kernel 7), and its forward +
    backward through autograd. Returns (fwd, fwd+bwd) ms."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.op import OpContext
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    xb = torch.from_numpy(rng.standard_normal((NB, NT, NH), np.float32)) \
        .to(dev).to(dtype).requires_grad_()
    dyb = torch.from_numpy(rng.standard_normal((NB, NT, NH), np.float32)) \
        .to(dev).to(dtype)
    ff = FFModel(FFConfig(), device="cuda")
    op = ff.lstm(ff.create_tensor((NB, NT, NH), dtype=dtype), NH,
                 name="lstm").owner_op
    params = {k: (torch.from_numpy(rng.standard_normal(s.shape, np.float32))
                  .to(dev) * 0.03).requires_grad_()
              for k, s in op.weight_specs().items()}
    ctx = OpContext(training=True)
    pfwd = lambda: op.forward(params, [xb], ctx)[0]    # noqa: E731
    return (cuda_ms(pfwd, 10), cuda_ms(lambda: torch.autograd.grad(
        pfwd(), [xb, *params.values()], dyb), 10))


def lstm_check(ls, xg, wh, h0, c0, dys, tag):
    """Kernels 7 and 8 against their plain versions on one input:
    {kernel: [(max abs error, error / max |plain|) per output]}; raises
    past LSTM_TOL. The backward runs on the plain forward's ys and cs,
    so both backward versions see one input. Returns the errors and the
    backward's arguments."""
    tol = LSTM_TOL[xg.dtype]
    ys, cs = ls.lstm_fwd_cuda(xg, wh, h0, c0)
    torch.cuda.synchronize()
    ys_ref, cs_ref = ls.lstm_fwd_ref(xg, wh, h0, c0)
    errs = {"lstm_fwd": [check_err(f"lstm_fwd {tag} {n}", a, r, tol,
                                   relative=True)
                         for n, a, r in (("ys", ys, ys_ref),
                                         ("cs", cs, cs_ref))]}
    bargs = (xg, wh, h0, c0, ys_ref, cs_ref, dys)
    got = ls.lstm_bwd_cuda(*bargs)
    torch.cuda.synchronize()
    want = ls.lstm_bwd_ref(*bargs)
    errs["lstm_bwd"] = [
        check_err(f"lstm_bwd {tag} {n}", a, r, tol, relative=True)
        for n, a, r in zip(("dxg", "dwh", "dh0", "dc0"), got, want)]
    return errs, bargs


def lstm_phase(ls):
    """Hold kernels 7 (lstm_fwd) and 8 (lstm_bwd) against their plain
    versions on the card at the NMT shapes, f32 and bf16, and at one odd
    shape (B and H off every tile, rows not 16-byte aligned); time the
    kernels and cuDNN's layer interleaved in 3 rounds, the plain
    versions and the port's own layer once."""
    from flexflow_tpu_torch import resolve_device
    resolve_device("cuda")            # TF32 off for the plain versions
    res = {}
    shape = f"T={NT} B={NB} H={NH}"
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xg, wh, h0, c0, dys = lstm_inputs(dtype)
        errs, bargs = lstm_check(ls, xg, wh, h0, c0, dys, dname)
        plain = {"lstm_fwd": cuda_ms(lambda: ls.lstm_fwd_ref(xg, wh, h0, c0),
                                     3),
                 "lstm_bwd": cuda_ms(lambda: ls.lstm_bwd_ref(*bargs), 3)}
        lib = cudnn_fns(dtype)
        fns = {"lstm_fwd": lambda: ls.lstm_fwd_cuda(xg, wh, h0, c0),
               "lstm_bwd": lambda: ls.lstm_bwd_cuda(*bargs)}
        if lib is not None:
            fns.update(cudnn_fwd=lib[0], cudnn_fwd_bwd=lib[1],
                       cudnn_bwd=lib[2])
        rounds = yardstick(fns)
        del xg, wh, h0, c0, dys, bargs, lib, fns
        torch.cuda.empty_cache()
        port = port_layer_ms(dtype)
        bounds = lstm_bounds(dtype)
        for i, (kname, lname) in enumerate((("lstm_fwd", "cudnn_fwd"),
                                            ("lstm_bwd", "cudnn_bwd"))):
            abs_err = max(e[0] for e in errs[kname])
            rel = max(e[1] for e in errs[kname])
            b_ms, b_by = bounds[kname]
            lib_rounds = rounds.get(lname)
            res.setdefault(kname, {})[dname] = {
                "max_abs_err": abs_err, "err_over_max_ref": rel,
                "ms": statistics.median(rounds[kname]),
                "plain_ms": plain[kname], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None if lib_rounds is None
                else statistics.median(lib_rounds),
                "ms_rounds": rounds[kname], "library_ms_rounds": lib_rounds,
                "port_layer_ms": port[i]}
            extra = ""
            if kname == "lstm_bwd":   # the old yardstick, beside
                fb = rounds.get("cudnn_fwd_bwd")
                res[kname][dname]["library_fwd_bwd_ms"] = (
                    None if fb is None else statistics.median(fb))
                res[kname][dname]["library_fwd_bwd_ms_rounds"] = fb
                extra = (" library_fwd_bwd_ms="
                         f"{'null' if fb is None else spread(fb)}")
            log(f"kernel {kname} [{dname}, {shape}]: max_abs_err="
                f"{abs_err:.3g} err/max|ref|={rel:.3g} (tol "
                f"{LSTM_TOL[dtype]}) kernel_ms={spread(rounds[kname])} "
                f"plain_ms={plain[kname]:.4f} bound_ms={b_ms:.4f} "
                f"({b_by}) library_ms="
                f"{'null' if lib_rounds is None else spread(lib_rounds)}"
                f"{extra} port_layer_ms={port[i]:.4f} [median (min-max) of 3 "
                f"interleaved rounds]")
        torch.cuda.empty_cache()
    # one odd shape: B=70 and H=100 off the tiles, H not a multiple of 8
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        rng = np.random.default_rng(13)
        dev = torch.device("cuda")

        def put(s, sc):
            return torch.from_numpy(rng.standard_normal(s, np.float32)
                                    * sc).to(dev)
        t, b, h = 3, 70, 100
        errs, _ = lstm_check(
            ls, put((t, b, 4 * h), 0.5).to(dtype),
            put((h, 4 * h), 0.1).to(dtype), put((b, h), 0.3),
            put((b, h), 0.3), put((t, b, h), 1.0).to(dtype),
            f"{dname} odd")
        for kname, e in errs.items():
            res[kname].setdefault("odd_shape", {})[dname] = {
                "shape": f"T={t} B={b} H={h}",
                "max_abs_err": max(x[0] for x in e),
                "err_over_max_ref": max(x[1] for x in e)}
        log(f"kernels lstm_* [{dname}, T={t} B={b} H={h}]: err/max|ref| "
            + ", ".join(f"{k} {max(x[1] for x in e):.3g}"
                        for k, e in errs.items())
            + f" (tol {LSTM_TOL[dtype]})")
    log("library_ms: lstm_fwd = torch.nn.LSTM forward, lstm_bwd = its "
        "backward alone (autograd.grad on a retained graph; "
        "library_fwd_bwd_ms = its forward + backward), cuDNN, D=H=1024, "
        "including the input product x.wx and its gradients that the "
        "kernels leave to matmuls; port_layer_ms = the port's LSTM op "
        "timed the same way (x.wx matmul + kernels)")
    return res


def nmt_batches(n, seed=0):
    """n host batches of the NMT model: tokens uniform over the
    vocabulary from a numpy seed (bench.py's nmt_lstm data), and as the
    label each row's first token, a task the model can learn (the CPU
    tests' task), so that the labels depend on what the LSTM carries."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(0, NV, (NB, NT)).astype(np.int32)
        out.append({"input": x, "label": x[:, 0].copy()})
    return out


def nmt_model(dtype, use_pallas, capture=True):
    """build_nmt_lstm at full width on the card, SGD lr 0.01; weights
    from the port's numpy streams, the same for every model built
    here. ``capture=False`` runs every step eagerly."""
    from flexflow_tpu_torch import FFConfig, SGDOptimizer, build_nmt_lstm
    m = build_nmt_lstm(FFConfig(batch_size=NB, seed=0), batch_size=NB,
                       seq_len=NT, vocab_size=NV, embed_dim=NH, hidden=NH,
                       num_layers=NL, dtype=dtype, use_pallas=use_pallas,
                       device="cuda")
    m.compile(optimizer=SGDOptimizer(lr=0.01),
              loss_type="sparse_categorical_crossentropy",
              metrics=["accuracy"], capture=capture)
    return m


def nmt_steps(dtype, use_pallas, batches, steps=3):
    """A fresh model's first `steps` steps: (losses, [{op.weight: its
    gradient} a step]), the gradients recorded as train_batch's
    executor computes them — eagerly: a replayed step runs no Python
    that could record them."""
    return record_steps(nmt_model(dtype, use_pallas, capture=False),
                        batches, steps)


def record_steps(m, batches, steps=3):
    """An eager model's first `steps` steps: (losses, [{op.weight: its
    gradient} a step]); drops the model."""
    ex, grads = m.executor, []
    compute = ex._compute_grads

    def record(params, batch, key=None, **kw):
        loss, logits, g, sparse_idx = compute(params, batch, key, **kw)
        grads.append({f"{op}.{k}": w.clone() for op, p in g.items()
                      for k, w in p.items()})
        return loss, logits, g, sparse_idx

    ex._compute_grads = record
    losses = [float(m.train_batch(batches[i])["loss"]) for i in range(steps)]
    del ex._compute_grads                 # no cycle keeps the model alive
    del m, ex, compute
    torch.cuda.empty_cache()
    return losses, grads


def grad_errs(gk, gp):
    """{weight: the largest |gk - gp| / |gp| (L2 norms) over the
    steps}: one path's gradients held against the other's."""
    out = {}
    for sk, sp in zip(gk, gp):
        for n, g in sp.items():
            diff, ref = float((sk[n] - g).norm()), float(g.norm())
            e = diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf)
            out[n] = max(out.get(n, 0.0), e)
    return out


def dwh_off_by_one(ls):
    """A planted fault for the gradient check's own test: lstm_bwd_cuda
    whose dwh sums h_t^T dlin_t where h_{t-1}^T dlin_t belongs. Returns
    (install, restore)."""
    real = ls.lstm_bwd_cuda

    def faulty(xg, wh, h0, c0, ys, cs, dys):
        dxg, dwh, dh0, dc0 = real(xg, wh, h0, c0, ys, cs, dys)
        t, b, h = ys.shape
        dwh = ys.reshape(t * b, h).float().t() @ \
            dxg.reshape(t * b, 4 * h).float()
        return dxg, dwh, dh0, dc0

    return (lambda: setattr(ls, "lstm_bwd_cuda", faulty),
            lambda: setattr(ls, "lstm_bwd_cuda", real))


def nmt_parity(ls, dtype, batches):
    """3 steps through the LSTM kernels against 3 on the scan cell, and
    3 more through the kernels with a planted fault in dwh: logs the
    losses and the gradient errors, then raises if the losses or a
    gradient differ past their limits, or if the fault reads within the
    limit."""
    dname = "f32" if dtype == torch.float32 else "bf16"
    lk, gk = nmt_steps(dtype, None, batches)
    lp, gp = nmt_steps(dtype, False, batches)
    errs = grad_errs(gk, gp)
    del gk
    install, restore = dwh_off_by_one(ls)
    install()
    try:
        _, gf = nmt_steps(dtype, None, batches)
    finally:
        restore()
    wh = sorted(n for n in gp[0] if n.startswith("lstm_") and
                n.endswith(".wh"))
    ferrs = grad_errs([{n: s[n] for n in wh} for s in gf],
                      [{n: s[n] for n in wh} for s in gp])
    del gf, gp
    torch.cuda.empty_cache()
    lstm = sorted(n for n in errs if n.startswith("lstm_"))
    worst = max(errs, key=errs.get)
    limit = NMT_GRAD_REL[dtype]
    loss_tol = NMT_F32_LOSS_REL if dtype == torch.float32 \
        else NMT_BF16_LOSS_REL
    log(f"train nmt {dname}: losses kernel {lk} plain {lp} (tol rel "
        f"{loss_tol}); gradient error |g_k - g_p| / |g_p| per LSTM weight "
        f"{ {n: f'{errs[n]:.3g}' for n in lstm} }, worst of all "
        f"{errs[worst]:.3g} at {worst} (limit {limit}); planted fault "
        f"(dwh over h_t) reads { {n: f'{ferrs[n]:.3g}' for n in wh} }")
    if not all(abs(a - b) <= loss_tol * abs(b) for a, b in zip(lk, lp)):
        raise AssertionError(f"nmt {dname} losses kernel {lk} vs plain {lp}")
    if not errs[worst] <= limit:
        raise AssertionError(f"nmt {dname} gradient of {worst} differs by "
                             f"{errs[worst]} > {limit}")
    if not min(ferrs.values()) > limit:
        raise AssertionError(f"nmt {dname}: the planted dwh fault reads "
                             f"{ferrs}, within the limit {limit}")


def nmt_train_phase(ls, card: str):
    """(a) f32 and bf16 parity: 3 steps through the LSTM kernels vs 3 on
    the scan cell, and a planted fault the check must catch; (b) the
    bf16 run: 3 warm-up steps and 20 timed ones through the kernels,
    with the launch counts checked (one forward and one backward call
    per layer per step, and the device kernels each call enqueued).
    Returns the launches of (b) and its numbers."""
    batches = nmt_batches(4)
    for dtype in (torch.float32, torch.bfloat16):
        nmt_parity(ls, dtype, batches)
    m = nmt_model(torch.bfloat16, None)
    nparams = sum(w.numel() for p in m.state.params.values()
                  for w in p.values())
    steps_warm, steps_timed = 3, 20
    torch.cuda.reset_peak_memory_stats()
    for counts in (ls.launches, ls.device_launches):   # the main path only
        counts.update(dict.fromkeys(counts, 0))
    warm = [float(m.train_batch(batches[i])["loss"])
            for i in range(steps_warm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [m.train_batch(batches[i % len(batches)])
               for i in range(steps_timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, device = dict(ls.launches), dict(ls.device_launches)
    peak = torch.cuda.max_memory_allocated()
    timed = [float(x["loss"]) for x in metrics]
    want = NL * (steps_warm + steps_timed)
    if launches != dict.fromkeys(launches, want):
        raise AssertionError(f"lstm launches {launches} != {NL} layers x "
                             f"{steps_warm + steps_timed} steps")
    # one device kernel a time step; the backward adds dh0 and dwh
    if device != {"lstm_fwd": want * NT, "lstm_bwd": want * (NT + 2)}:
        raise AssertionError(f"lstm device launches {device} for {want} "
                             f"calls each")
    if not all(math.isfinite(x) for x in warm + timed):
        raise AssertionError(f"non-finite loss in {warm + timed}")
    step_ms = 1e3 * wall / steps_timed
    res = {"step_ms": step_ms, "samples_per_s": NB * steps_timed / wall,
           "tokens_per_s": NB * NT * steps_timed / wall,
           "peak_mem_gib": peak / 2**30, "launches": launches,
           "device_launches": device, "losses": warm + timed}
    log(f"train nmt bf16 [{card}]: {nparams / 1e6:.2f} M params; launches "
        f"{launches} (= {NL} layers x {steps_warm + steps_timed} steps), "
        f"device kernels enqueued {device} ("
        f"{device['lstm_fwd'] / launches['lstm_fwd']:g} a forward call, "
        f"{device['lstm_bwd'] / launches['lstm_bwd']:g} a backward call)")
    log(f"train nmt bf16 [{card}]: step ms {step_ms:.3f} over "
        f"{steps_timed} steps, {res['samples_per_s']:.1f} samples/s, "
        f"{res['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{res['peak_mem_gib']:.2f} GiB, losses {warm + timed}")
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


def serve_phase(pr, fa, card: str, lm):
    """Serve ``lm`` — the f32 LM FFModel lm_train_phase just trained,
    its live parameters — on the card four times: the mixed step on f32
    pages, on int8 and on fp8 pages, and the legacy bucket path on f32
    pages. Each run's engine captures its programs in warmup(); its
    compile_counts() must read the path's families then and unchanged
    after generate(). Its greedy tokens are held against one no-cache
    reference, and all of its tokens against an eager engine's run
    (capture=False) token for token. Each run's kernel launches are
    counted from 0 just before it (a replay counts each launch of its
    graph). Returns {run: (launches, stats, eager stats)}."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import ServeEngine
    nparams = sum(w.numel() for p in lm.state.params.values()
                  for w in p.values())
    vocab = LM_ARCH["vocab_size"]
    log(f"serve: the trained LM, {nparams / 1e6:.1f} M params f32")
    greedy, sampled = serve_prompts(vocab)
    prompts = greedy + [sampled]
    new = 32
    kw = dict(temperature=[None] * len(greedy) + [0.8],
              top_k=[None] * len(greedy) + [8], sample_seed=7)
    runs, ref = {}, None
    # FFConfig defaults: kv_page_size 16, kv_num_pages 257, 8 seqs, 512
    for run, cfg in (("f32", FFConfig()),
                     ("int8", FFConfig(kv_dtype="int8")),
                     ("fp8", FFConfig(kv_dtype="float8_e4m3")),
                     ("legacy_f32", FFConfig(serve_chunked_prefill=False))):
        eng = ServeEngine(lm, cfg, device="cuda")
        counts = eng.warmup()
        want_counts = ({"prefill": 0, "decode": 0, "mixed": 1}
                       if eng.chunked_prefill else
                       {"prefill": len(eng.buckets), "decode": 1,
                        "mixed": 0})
        if counts != want_counts:
            raise AssertionError(f"{run}: captures after warmup {counts} "
                                 f"!= {want_counts}")
        log(f"serve {run}: KV pool {eng.cache_cfg.kv_dtype} "
            f"{eng.cache_cfg.pool_bytes / 2**20:.1f} MiB, warmup (captures "
            f"{counts}) {eng.boot_stats['boot_s']:.3f} s")
        pr.launches = 0                   # count this run's path only
        fa.launches["paged_decode"] = 0
        out = eng.generate(prompts, new, **kw)
        launches = {"paged_ragged_v2": pr.launches,
                    "paged_decode": fa.launches["paged_decode"]}
        st = eng.last_stats
        if eng.compile_counts() != counts:
            raise AssertionError(f"{run}: captures grew in generate: "
                                 f"{eng.compile_counts()} != {counts}")
        if [len(o) for o in out] != [new] * len(prompts):
            raise AssertionError(
                f"{run}: wrong output lengths {[len(o) for o in out]}")
        if not all(0 <= t < vocab for o in out for t in o):
            raise AssertionError(f"{run}: token outside the vocabulary")
        layers = eng.num_layers
        if eng.chunked_prefill:
            want = {"paged_ragged_v2": layers * st["steps"],
                    "paged_decode": 0}
            what = f"{layers} layers x {st['steps']} steps"
        else:
            want = {"paged_ragged_v2": 0,
                    "paged_decode": layers * st["decode_steps"]}
            what = f"{layers} layers x {st['decode_steps']} decode steps"
        if launches != want or not max(launches.values()):
            raise AssertionError(
                f"{run}: kernel launches {launches} != {want} ({what})")
        if ref is None:
            ref = eng.generate_reference(greedy, new)
        # f32 pools: the kernels' online softmax rounds differently from
        # the single-pass reference, so ties flip at a small margin;
        # quantized pools: the pool's own tie margin
        margin = None if eng.kv_quantized else PARITY_MARGIN
        exact = eng.assert_token_parity(greedy, out[:len(greedy)], ref,
                                        margin=margin)
        margin = eng.kv_tie_margin if margin is None else margin
        # the same run eagerly: every step run op by op, no graph
        eng.close()
        eager = ServeEngine(lm, cfg, device="cuda", capture=False)
        eager.warmup()
        out_e = eager.generate(prompts, new, **kw)
        st_e = eager.last_stats
        if out_e != out:
            raise AssertionError(f"{run}: captured tokens differ from the "
                                 f"eager run's")
        log(f"serve {run} [{card}]: mode={st['mode']} steps={st['steps']} "
            f"decode_steps={st['decode_steps']} kernel_launches="
            f"{launches} (= {what}) prefix_hit_tokens="
            f"{st['prefix_hit_tokens']} preemptions={st['preemptions']} "
            f"spec accepted/drafted={st['spec_accepted_tokens']}/"
            f"{st['spec_drafted_tokens']} greedy token-identical to "
            f"reference: {exact}/{len(greedy)} (rest diverge at a tie <= "
            f"{margin}); all {len(prompts)} streams token-identical to the "
            f"eager run; captures {eng.compile_counts()} unchanged, "
            f"replays {eng.programs.replay_counts()}")
        for mode, x in (("captured", st), ("eager", st_e)):
            pre_lanes = sum(n for n, _ in x["prefill_times_s"])
            pre_s = sum(t for _, t in x["prefill_times_s"])
            log(f"serve {run} {mode} [{card}]: decode step ms mean="
                f"{1e3 * float(np.mean(x['decode_step_times_s'])):.3f} "
                f"over {x['decode_steps']} steps; prefill tokens/s="
                f"{pre_lanes / pre_s:.1f}; output tokens/s="
                f"{x['tokens_per_sec']:.1f} ({x['total_new_tokens']} "
                f"tokens in {x['wall_s']:.3f} s)")
        runs[run] = (launches, st, st_e)
        del eng, eager
        gc.collect()
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------- the training loop
# the LM at full width with GPT-2's resid_pdrop / attn_pdrop of 0.1 where
# the JAX package applies them (attention's output, a Dropout after each
# block's FFN), trained through fit under the bf16 policy
LM_DROPOUT = 0.1
FIT_STEPS = 8
DROPOUT_SHAPES = ((LB, TS, 512), (3, 1001, 77))


def dropout_lm_graph(batch, vocab_size, max_seq_len, hidden, num_heads,
                     num_layers, ff_dim, compute_dtype="bfloat16",
                     remat=False, seed=0, device="cuda", p=LM_DROPOUT):
    """build_transformer_lm's graph, op for op with its op names, plus
    dropout ``p`` on each attention op and a Dropout(p) after each
    block's FFN, built with the port's FFModel calls
    (``build_transformer_lm`` takes no dropout argument, as the JAX
    function does not)."""
    from flexflow_tpu_torch import FFConfig, FFModel
    cfg = FFConfig(batch_size=batch, seed=seed, compute_dtype=compute_dtype,
                   remat=remat)
    ff = FFModel(cfg, device=device)
    tokens = ff.create_tensor((batch, max_seq_len), dtype=torch.int32,
                              name="tokens")
    positions = ff.create_tensor((batch, max_seq_len), dtype=torch.int32,
                                 name="positions")
    te = ff.embedding(tokens, vocab_size, hidden, aggr="none",
                      name="tok_embed", dtype=cfg.compute_dtype)
    pe = ff.embedding(positions, max_seq_len, hidden, aggr="none",
                      name="pos_embed", dtype=cfg.compute_dtype)
    t = ff.add(te, pe, name="embed_add")
    for i in range(num_layers):
        a_in = ff.layer_norm(t, name=f"layer{i}_ln1")
        a = ff.multihead_attention(a_in, a_in, a_in, hidden, num_heads,
                                   dropout=p, causal=True,
                                   name=f"layer{i}_attn")
        t = ff.add(a, t, name=f"layer{i}_res1")
        f_in = ff.layer_norm(t, name=f"layer{i}_ln2")
        h = ff.dense(f_in, ff_dim, activation="relu", name=f"layer{i}_ff1")
        h = ff.dense(h, hidden, name=f"layer{i}_ff2")
        h = ff.dropout(h, p, name=f"layer{i}_drop")
        t = ff.add(h, t, name=f"layer{i}_res2")
    t = ff.layer_norm(t, name="final_ln")
    ff.dense(t, vocab_size, name="lm_head")
    return ff


def fit_model(batch=None, remat=False, capture=True):
    """The dropout LM at full width under the bf16 policy, SGD lr 0.01
    momentum 0.9 (the LM phase's optimizer), weights from the port's
    numpy streams of seed 0."""
    from functools import partial
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.core.losses import \
        sparse_categorical_crossentropy
    m = dropout_lm_graph(batch or LB, remat=remat, **LM_ARCH)
    m.compile(optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
              loss_type=partial(sparse_categorical_crossentropy,
                                from_logits=True),
              metrics=[], capture=capture)
    return m


def lm_arrays(rows, seed=0):
    """fit's arrays for the LM: tokens, positions, next-token labels."""
    b = lm_batches(1, seed)[0]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, LM_ARCH["vocab_size"], (rows, TS)) \
        .astype(np.int32)
    pos = np.tile(b["positions"][:1], (rows, 1))
    return {"tokens": toks, "positions": pos}, np.roll(toks, -1, axis=1)


def profiled(fn):
    """(wall s, device busy s) of fn() under torch.profiler (CPU + CUDA
    activities), the window ending in a synchronize."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(float(e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    return wall, busy


def masters_equal(a, b, what):
    wdiff, worst = max_weight_diff(weights_of(a), weights_of(b))
    if wdiff != 0.0:
        raise AssertionError(f"{what}: masters differ by {wdiff} at {worst}")


def fit_loop_phase(kd, fa, card: str):
    """The slice's full-width path: the dropout LM trained through fit.
    (a) prefetch on against off, 3 epochs of 8 steps each (captured;
    the second epoch timed, the third profiled): masters bit for bit;
    the dropout launches of the prefetch run counted. (b)
    steps_per_dispatch=4 against 1: bit for bit, one train_step_multi
    capture. (c) grad_accum_steps=4 on microbatches of 4 x 512,
    captured against eager: bit for bit. (d) remat against off: bit for
    bit, the flash forward launched 2 x 6 layers a step. (e) 2 epochs x
    4 steps with a checkpoint directory, killed at train.dispatch in
    epoch 1, run again: equal to an uninterrupted run bit for bit.
    Returns its numbers and the dropout launches of (a)'s main path."""
    import tempfile
    from flexflow_tpu_torch.utils import faults
    layers = LM_ARCH["num_layers"]
    x, y = lm_arrays(LB * FIT_STEPS)
    t_phase = time.perf_counter()
    res, models = {}, {}

    def run_fit(m, **kw):
        return m.fit(x, y, epochs=1, verbose=False, shuffle=True, **kw)

    # (a) prefetch, the main path of the dropout kernel
    for prefetch in (False, True):
        m = fit_model()
        if prefetch:
            kd.launches.update(dict.fromkeys(kd.launches, 0))
            fa.launches.update(dict.fromkeys(fa.launches, 0))
        run_fit(m, prefetch=prefetch)                     # captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_fit(m, prefetch=prefetch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / FIT_STEPS
        pwall, busy = profiled(lambda: run_fit(m, prefetch=prefetch))
        counts = m.compile_counts()
        if counts != {"train_step": 1}:
            raise AssertionError(f"fit prefetch={prefetch}: captures "
                                 f"{counts}")
        if prefetch:
            launches = dict(kd.launches)
            want = 2 * layers * 3 * FIT_STEPS
            if launches != {"dropout_fwd": want, "dropout_bwd": want}:
                raise AssertionError(f"dropout launches {launches} != 2 x "
                                     f"{layers} layers x "
                                     f"{3 * FIT_STEPS} steps each way")
            flash = {k: fa.launches[k] for k in fa.FLASH_KERNELS}
            if flash != dict.fromkeys(flash, layers * 3 * FIT_STEPS):
                raise AssertionError(f"fit (a): flash launches {flash}")
        res[f"prefetch_{prefetch}"] = {
            "step_ms": 1e3 * wall, "device_ms": 1e3 * busy / FIT_STEPS,
            "profiled_step_ms": 1e3 * pwall / FIT_STEPS,
            "idle_share": 1.0 - busy / pwall}
        log(f"fit (a) prefetch={prefetch} [{card}]: step wall "
            f"{1e3 * wall:.3f} ms, device {1e3 * busy / FIT_STEPS:.3f} ms "
            f"a step, idle share {1.0 - busy / pwall:.3f} (profiled wall "
            f"{1e3 * pwall / FIT_STEPS:.3f} ms a step)")
        release(m)
        models[prefetch] = m
    masters_equal(models[True], models[False], "fit (a) prefetch")
    log(f"fit (a): prefetch on and off give the same masters after "
        f"{3 * FIT_STEPS} steps bit for bit; dropout launches {launches}, "
        f"flash launches {flash}")
    del models

    # (b) multi-step dispatch
    runs = {}
    for spd in (1, 4):
        m = fit_model()
        hist = m.fit(x, y, epochs=2, verbose=False, steps_per_dispatch=spd)
        want = ({"train_step": 1} if spd == 1 else
                {"train_step": 0, "train_step_multi": 1})
        if m.compile_counts() != want:
            raise AssertionError(f"fit (b) spd={spd}: captures "
                                 f"{m.compile_counts()} != {want}")
        runs[spd] = ([h["loss"] for h in hist], m)
        release(m)
    if runs[1][0] != runs[4][0]:
        raise AssertionError(f"fit (b) losses {runs[1][0]} vs {runs[4][0]}")
    masters_equal(runs[1][1], runs[4][1], "fit (b) steps_per_dispatch")
    res["multi_losses"] = runs[4][0]
    log(f"fit (b): steps_per_dispatch=4 equals 1 bit for bit over 2 "
        f"epochs (losses {[round(v, 4) for v in runs[4][0]]}); captures "
        f"{runs[4][1].compile_counts()}")
    del runs

    # (c) gradient accumulation, captured against eager
    runs = {}
    for capture in (True, False):
        m = fit_model(batch=4, capture=capture)
        hist = m.fit(x, y, batch_size=4, epochs=1, verbose=False,
                     grad_accum_steps=4)
        if m.state.step != len(y) // 16:       # 4 microbatches of 4
            raise AssertionError(f"fit (c): {m.state.step} updates")
        runs[capture] = ([h["loss"] for h in hist], m)
        release(m)
    if runs[True][0] != runs[False][0]:
        raise AssertionError(f"fit (c) losses {runs[True][0]} vs "
                             f"{runs[False][0]}")
    masters_equal(runs[True][1], runs[False][1], "fit (c) accumulation")
    log(f"fit (c): grad_accum_steps=4 (microbatches 4 x {TS}) captured "
        f"equals eager bit for bit; {len(y) // 16} updates, captures "
        f"{runs[True][1].compile_counts()}")
    del runs

    # (d) remat
    runs = {}
    for remat in (False, True):
        m = fit_model(remat=remat)
        torch.cuda.reset_peak_memory_stats()
        fa.launches["flash_fwd"] = 0
        hist = m.fit(x, y, epochs=1, verbose=False)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        fwd = fa.launches["flash_fwd"]
        if fwd != (2 if remat else 1) * layers * FIT_STEPS:
            raise AssertionError(f"fit (d) remat={remat}: flash forward "
                                 f"launches {fwd}")
        runs[remat] = ([h["loss"] for h in hist], m, peak, fwd)
        release(m)
    if runs[True][0] != runs[False][0]:
        raise AssertionError(f"fit (d) losses {runs[True][0]} vs "
                             f"{runs[False][0]}")
    masters_equal(runs[True][1], runs[False][1], "fit (d) remat")
    res["remat_peak_gib"] = runs[True][2]
    res["no_remat_peak_gib"] = runs[False][2]
    log(f"fit (d): remat equals no remat bit for bit (deterministic "
        f"kernels); flash forward launches {runs[True][3]} (= 2 x "
        f"{layers} x {FIT_STEPS}) against {runs[False][3]}; peak memory "
        f"{runs[True][2]:.3f} GiB with remat, {runs[False][2]:.3f} "
        f"without")
    del runs

    # (e) crash and resume
    xe, ye = lm_arrays(LB * 4, seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        ref = fit_model()
        ref.fit(xe, ye, epochs=2, verbose=False)
        release(ref)
        ck = str(Path(tmp) / "ck")
        m = fit_model()
        try:
            with faults.active("train.dispatch:kill@6"):
                m.fit(xe, ye, epochs=2, verbose=False, checkpoint_dir=ck)
            raise AssertionError("fit (e): the planted kill did not fire")
        except faults.SimulatedKill:
            pass
        release(m)
        del m
        visible = sorted(d for d in Path(ck).iterdir())
        if [d.name for d in visible] != ["epoch_0"]:
            raise AssertionError(f"fit (e): checkpoints {visible}")
        m = fit_model()
        hist = m.fit(xe, ye, epochs=2, verbose=False, checkpoint_dir=ck)
        if [h["epoch"] for h in hist] != [1]:
            raise AssertionError(f"fit (e): resumed epochs {hist}")
        masters_equal(m, ref, "fit (e) resume")
        from flexflow_tpu_torch.core.checkpoint import save_model
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_model(m, str(Path(tmp) / "timed"))
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size
                     for f in (Path(tmp) / "timed").iterdir())
        release(m)
    res["save_s"] = save_s
    res["save_bytes"] = nbytes
    log(f"fit (e): killed at train.dispatch in epoch 1, resumed from "
        f"epoch_0: masters equal the uninterrupted run's bit for bit; a "
        f"synchronous save of params, slots and step ({nbytes / 2**20:.1f} "
        f"MiB) took {save_s:.3f} s")
    del ref, m
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fit loop phase {time.perf_counter() - t_phase:.1f} s")
    return res, launches


def dropout_phase(kd):
    """(f) the dropout kernel against its plain version bit for bit,
    f32 and bf16, forward and backward (the kernel on the gradient,
    through autograd), at the LM's activation and an odd shape; timed
    beside its bound (the larger of x read once and y written once over
    the HBM rate, and threefry's 32-bit integer operations over the
    INT32 rate) and beside torch.nn.functional.dropout on the same
    tensor (another random stream: the same work, not the same mask)."""
    from flexflow_tpu_torch.core import prng
    key = torch.from_numpy(prng.key_words(prng.fold_in(prng.prng_key(0),
                                                       3))).cuda()
    fold, keep = 1234567, 1.0 - LM_DROPOUT
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in DROPOUT_SHAPES:
            rng = np.random.default_rng(0)
            x = torch.from_numpy(rng.standard_normal(shape, np.float32)) \
                .cuda().to(dtype)
            g = torch.from_numpy(rng.standard_normal(shape, np.float32)) \
                .cuda().to(dtype)
            y = kd.dropout_cuda(x, key, fold, keep)
            xg = x.clone().requires_grad_()
            (dx,) = torch.autograd.grad(kd.dropout(xg, key, fold, keep),
                                        xg, g)
            torch.cuda.synchronize()
            for name, got, want in (
                    ("dropout_fwd", y, kd.dropout_ref(x, key, fold, keep)),
                    ("dropout_bwd", dx, kd.dropout_ref(g, key, fold, keep))):
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {dtype} {shape}: kernel "
                                         f"differs from its plain version")
            cell = f"{'bf16' if dtype == torch.bfloat16 else 'f32'} " \
                   f"{'x'.join(map(str, shape))}"
            nbytes = 2 * x.numel() * x.element_size()
            int_ops = (DROPOUT_INT_OPS_PER_ELEMENT * x.numel()
                       + DROPOUT_INT_OPS_PER_CALL)
            bms, by = bound(nbytes, int_ops, torch.int32)
            times = {
                "dropout_fwd": cuda_ms(
                    lambda: kd.dropout_cuda(x, key, fold, keep), 20),
                "dropout_bwd": cuda_ms(
                    lambda: kd.dropout_cuda(g, key, fold, keep,
                                            direction="dropout_bwd"), 20)}
            plain_ms = cuda_ms(lambda: kd.dropout_ref(x, key, fold, keep), 5)
            lib_ms = cuda_ms(lambda: torch.nn.functional.dropout(
                x, LM_DROPOUT, training=True), 20)
            for name in ("dropout_fwd", "dropout_bwd"):
                out.setdefault(name, {})[cell] = {
                    "max_abs_err": 0.0, "ms": times[name],
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_ms}
            log(f"dropout {cell}: kernel = plain version bit for bit "
                f"(fwd and bwd); fwd {times['dropout_fwd']:.4f} ms, bwd "
                f"{times['dropout_bwd']:.4f} ms, bound {bms:.4f} ms "
                f"({by}; bytes alone {bound(nbytes, 0.0, dtype)[0]:.4f}), "
                f"plain {plain_ms:.4f} ms, F.dropout "
                f"{lib_ms:.4f} ms (its own random stream)")
    return out


# ------------------------------------------------------------ conv sweep
# The conv and MLP models of the sweep and the seq2seq NMT at the widths
# their users run (bench.py's "full" preset where it has one; ResNet-50
# at ImageNet geometry; CANDLE-Uno and the seq2seq at their builders'
# defaults): builder, its arguments, batch, how the model goes bf16
# ("dtype": the builder's activation dtype; "policy": compute_dtype;
# None: f32), the loss
SWEEP = {
    "alexnet": ("build_alexnet", dict(num_classes=10, image_size=32), 256,
                "dtype", "sparse_categorical_crossentropy"),
    "inception": ("build_inception_v3", dict(num_classes=10,
                                             image_size=299), 32,
                  "dtype", "sparse_categorical_crossentropy"),
    "resnet50": ("build_resnet", dict(depth=50, num_classes=1000,
                                      image_size=224), 32,
                 "policy", "sparse_categorical_crossentropy"),
    "candle_uno": ("build_candle_uno", {}, 64, None, "mean_squared_error"),
    "seq2seq": ("build_nmt_seq2seq", {}, 64, "dtype",
                "sparse_categorical_crossentropy"),
}
PARITY_BATCH = 4
# the card's f32 step against the port's CPU step on the same weights and
# batch: the loss (relative), the update of all weights together,
# ||du_card - du_cpu|| / ||du_cpu|| over their concatenation, each
# weight's update, and the running statistics' change. The yardstick is
# the function's own conditioning, read on the CPU: the same CPU step
# from the weights moved by one ulp each (up or down at random; three
# numpy seeds, each measure at its largest over the three). A deep
# ReLU net's gradient is not continuous: one activation that crosses 0
# under a rounding change moves the whole update below it, and in
# ResNet-50 and Inception a one-ulp change of the weights moves the
# first update by about 2% (JAX alone shows the same at the CPU tests'
# size, tests/test_torch_conv_models.py). In the BatchNorm nets each
# measure is held within SPREAD_FACTOR times that witness, or the fixed
# limit below where that is larger; the other models meet the fixed
# limits (their witness is logged). The loss is a forward quantity and
# has a fixed limit
CPU_LOSS_REL = 1e-4
UPDATE_REL = 1e-3
STATES_REL = 1e-5
SPREAD_FACTOR = 2.0
WITNESS_SEEDS = 3
# each weight's update is held relative to its own norm or to this share
# of the model's largest, whichever is larger
UPDATE_FLOOR = 1e-2
# sibling fusion off against on: each output channel's sum is unchanged
KNOB_LOSS_REL = 1e-4
SWEEP_WINDOWS, SWEEP_STEPS = 3, 20
# the LSTM kernels at the seq2seq's shapes (build_nmt_seq2seq defaults)
S2S_T, S2S_B, S2S_H = 20, 64, 512


def sweep_model(name, batch, dtype, device="cuda", capture=True, **cfg):
    """One model of SWEEP on ``device``, SGD lr 0.01, weights from the
    port's numpy streams of seed 0 (the same on every device).
    ``dtype``: torch.float32, or torch.bfloat16 by the model's route."""
    import flexflow_tpu_torch as ft
    fn, kw, _, route, loss = SWEEP[name]
    if dtype == torch.bfloat16 and route == "policy":
        cfg["compute_dtype"] = "bfloat16"
    if dtype == torch.bfloat16 and route == "dtype":
        kw = {**kw, "dtype": torch.bfloat16}
    m = getattr(ft, fn)(ft.FFConfig(batch_size=batch, seed=0, **cfg),
                        batch_size=batch, device=device, **kw)
    m.compile(optimizer=ft.SGDOptimizer(lr=0.01), loss_type=loss,
              metrics=[], capture=capture)
    return m


def sweep_batches(name, batch, n, seed=0):
    """n host batches for a SWEEP model from a numpy seed: images and
    class labels, CANDLE-Uno's features and a regression target, or
    source and target tokens with next-token labels."""
    rng = np.random.default_rng(seed)
    _, kw, _, _, _ = SWEEP[name]
    out = []
    for _ in range(n):
        if name == "candle_uno":
            from flexflow_tpu_torch.models.candle_uno import \
                DEFAULT_FEATURE_SHAPES
            b = {k: rng.standard_normal((batch, d), np.float32)
                 for k, d in DEFAULT_FEATURE_SHAPES.items()}
            b["label"] = rng.standard_normal((batch, 1), np.float32)
        elif name == "seq2seq":
            b = {k: rng.integers(0, 16000, (batch, 20)).astype(np.int32)
                 for k in ("src", "tgt")}
            b["label"] = np.roll(b["tgt"], -1, axis=1)
        else:
            s = kw["image_size"]
            b = {"input": rng.standard_normal((batch, 3, s, s), np.float32),
                 "label": rng.integers(0, kw["num_classes"], batch)
                 .astype(np.int32)}
        out.append(b)
    return out


def states_of(m):
    return {f"{op}.{k}": s.detach().clone()
            for op, st in m.state.states.items() for k, s in st.items()}


def update_err(w0, wa, wb):
    """||du_a - du_b|| / ||du_b|| over all weights concatenated, du the
    change from w0 (each on the CPU, f32)."""
    num = den = 0.0
    for n, w in w0.items():
        da = wa[n].float().cpu() - w
        db = wb[n].float().cpu() - w
        num += float((da - db).square().sum())
        den += float(db.square().sum())
    return math.sqrt(num / den)


def worst_updates(w0, wa, wb, n=3):
    """The n weights whose updates differ most: [(name, ||du_a - du_b|| /
    max(||du_b||, UPDATE_FLOOR x the largest ||du_b|| of the model),
    ||du_b||)]. The floor holds a weight whose update is tiny to an
    absolute error instead (a conv bias before a BatchNorm: its true
    update is zero, what is left is rounding)."""
    rows = []
    for k, w in w0.items():
        da = wa[k].float().cpu() - w
        db = wb[k].float().cpu() - w
        rows.append((k, float((da - db).norm()), float(db.norm())))
    floor = UPDATE_FLOOR * max(nb for _, _, nb in rows)
    out = [(k, d / max(nb, floor), nb) for k, d, nb in rows]
    return sorted(out, key=lambda e: -e[1])[:n]


def one_step(m, batch):
    """(loss, weights after, running statistics after) of one train
    step."""
    loss = float(m.train_batch(batch)["loss"])
    return loss, weights_of(m), states_of(m)


def states_err(s0, sa, sb):
    """||ds_a - ds_b|| / ||ds_b|| over all running statistics
    concatenated, ds the change from s0 (None without statistics)."""
    if not s0:
        return None
    num = den = 0.0
    for n, s in s0.items():
        da = sa[n].float().cpu() - s.cpu()
        db = sb[n].float().cpu() - s.cpu()
        num += float((da - db).square().sum())
        den += float(db.square().sum())
    return math.sqrt(num / den)


def move_one_ulp(m, seed=0):
    """Move every weight of a CPU model by one ulp, up or down at random
    (a numpy seed, weights in name order)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for op in sorted(m.state.params):
            for k in sorted(m.state.params[op]):
                w = m.state.params[op][k]
                up = torch.from_numpy(rng.random(tuple(w.shape)) < 0.5)
                w.copy_(torch.nextafter(w, torch.where(
                    up, torch.tensor(math.inf), torch.tensor(-math.inf))))


def compare_steps(w0, s0, a, b):
    """The measures of step a = (loss, weights, states) against step b."""
    return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
            "update_rel": update_err(w0, a[1], b[1]),
            "worst_weights": worst_updates(w0, a[1], b[1]),
            "states_rel": states_err(s0, a[2], b[2])}


def sweep_parity(name):
    """The card's f32 step against the port's CPU step (one f32 step,
    batch 4, the same weights and batch), held within SPREAD_FACTOR
    times the CPU's one-ulp witness in the BatchNorm nets and within the
    fixed limits in the others; then the knobs on the card: NHWC against
    NCHW within the same limits, and sibling fusion off against on,
    where the model has sibling convs, within the fixed ones.
    Returns (the measures, the failures past the limits): the phase
    raises after every model has run, so one run reports every
    measure."""
    batch = sweep_batches(name, PARITY_BATCH, 1, seed=1)[0]
    cpu = sweep_model(name, PARITY_BATCH, torch.float32, device="cpu")
    w0 = {n: w.float().clone() for n, w in weights_of(cpu).items()}
    s0 = states_of(cpu)
    t0 = time.perf_counter()
    stc = one_step(cpu, batch)
    cpu_s = time.perf_counter() - t0
    del cpu
    runs = []
    for seed in range(WITNESS_SEEDS):
        ulp = sweep_model(name, PARITY_BATCH, torch.float32, device="cpu")
        move_one_ulp(ulp, seed)
        runs.append(compare_steps(w0, s0, one_step(ulp, batch), stc))
        del ulp
    # each measure at its largest over the seeds (running statistics:
    # None in a model without them)
    witness = {
        "loss_rel": max(r["loss_rel"] for r in runs),
        "update_rel": max(r["update_rel"] for r in runs),
        "worst_weights": max((r["worst_weights"] for r in runs),
                             key=lambda e: e[0][1]),
        "states_rel": max((r["states_rel"] or 0.0 for r in runs),
                          default=0.0) if s0 else None}
    card = sweep_model(name, PARITY_BATCH, torch.float32, capture=False)
    same = max_weight_diff({n: w.cuda() for n, w in w0.items()},
                           weights_of(card))
    if same[0] != 0.0:
        raise AssertionError(f"{name}: card and CPU initial weights differ "
                             f"{same}")
    groups = len(card.executor._conv_merge_leader)
    stg = one_step(card, batch)
    del card
    res = {"cpu_step_s": cpu_s, "loss_card": stg[0], "loss_cpu": stc[0],
           **compare_steps(w0, s0, stg, stc), "ulp_witness": witness,
           "sibling_groups": groups}
    knobs = {}
    if name not in ("candle_uno", "seq2seq"):
        knobs["nhwc"] = {"conv_layout": "NHWC"}
    if groups:
        knobs["no_sibling_fusion"] = {"sibling_conv_fusion": False}
    for kname, cfg in knobs.items():
        m = sweep_model(name, PARITY_BATCH, torch.float32, capture=False,
                        **cfg)
        res[kname] = compare_steps(w0, s0, one_step(m, batch), stg)
        del m
    torch.cuda.empty_cache()
    by_witness = {"update_rel": max(UPDATE_REL, SPREAD_FACTOR
                                    * witness["update_rel"]),
                  "each": max(UPDATE_REL, SPREAD_FACTOR
                              * witness["worst_weights"][0][1]),
                  "states_rel": max(STATES_REL, SPREAD_FACTOR
                                    * (witness["states_rel"] or 0.0))}
    fixed = {"update_rel": UPDATE_REL, "each": UPDATE_REL,
             "states_rel": STATES_REL}
    # the witness sets the limits of the BatchNorm nets; the others meet
    # the fixed ones
    lim = by_witness if s0 else fixed
    fails = []
    checks = [("card vs CPU", res, CPU_LOSS_REL, lim)]
    if "nhwc" in res:
        checks.append(("nhwc", res["nhwc"], KNOB_LOSS_REL, lim))
    if "no_sibling_fusion" in res:
        checks.append(("no_sibling_fusion", res["no_sibling_fusion"],
                       KNOB_LOSS_REL, fixed))
    for what, r, loss_limit, lm in checks:
        r["limits"] = {"loss_rel": loss_limit, **lm}
        if not (r["loss_rel"] <= loss_limit
                and r["update_rel"] <= lm["update_rel"]
                and r["worst_weights"][0][1] <= lm["each"]
                and (r["states_rel"] is None
                     or r["states_rel"] <= lm["states_rel"])):
            fails.append(f"{name} {what}: {r}")
    return res, fails


def timed_windows(m, batch, windows=SWEEP_WINDOWS, steps=SWEEP_STEPS):
    """Step wall ms of each of ``windows`` windows of ``steps`` train
    steps on one device-resident batch, each window ending in a loss
    read and a synchronize."""
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = m.train_batch(batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / steps)
    return out


def sweep_main(name, card: str, ls=None):
    """The main path at full width (bf16 where the model's users run it,
    else f32): 3 eager steps against 3 captured ones bit for bit
    (losses, weights, running statistics), then 3 windows of 20 timed
    captured steps. ``ls`` (the seq2seq): the LSTM kernels' counts are
    zeroed just before the captured model runs and read after."""
    _, _, batch, route, _ = SWEEP[name]
    dtype = torch.float32 if route is None else torch.bfloat16
    host = sweep_batches(name, batch, 3, seed=2)
    eager = sweep_model(name, batch, dtype, capture=False)
    dev = [eager.executor.shard_batch(b) for b in host]
    le = [float(eager.train_batch(b)["loss"]) for b in dev]
    we, se = weights_of(eager), states_of(eager)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if ls is not None:
        for counts in (ls.launches, ls.device_launches):
            counts.update(dict.fromkeys(counts, 0))
    m = sweep_model(name, batch, dtype)
    lcap = [float(m.train_batch(b)["loss"]) for b in dev]
    wdiff = max_weight_diff(we, weights_of(m))
    sc = states_of(m)
    sdiff = max([(float((se[n] - sc[n]).abs().max()), n) for n in se]
                or [(0.0, None)])
    if lcap != le or wdiff[0] != 0.0 or sdiff[0] != 0.0:
        raise AssertionError(f"{name}: captured steps differ from eager: "
                             f"losses {lcap} vs {le}, weights {wdiff}, "
                             f"running stats {sdiff}")
    ms = timed_windows(m, dev[0])
    launches = None
    if ls is not None:
        launches = (dict(ls.launches), dict(ls.device_launches))
    peak = torch.cuda.max_memory_allocated()
    counts = m.compile_counts()
    flops = 3.0 * sum(op.flops() for op in m.ops) / batch
    med = statistics.median(ms)
    sps = batch * 1e3 / med
    nparams = sum(w.numel() for p in m.state.params.values()
                  for w in p.values())
    res = {"batch": batch, "dtype": str(dtype).replace("torch.", ""),
           "params_m": nparams / 1e6, "step_ms": med, "step_ms_range":
           [min(ms), max(ms)], "step_ms_windows": ms,
           "samples_per_s": sps, "train_flops_per_sample": flops,
           "mfu_bf16_peak": flops * sps / FLOPS_PER_S[torch.bfloat16],
           "peak_mem_gib": peak / 2**30, "captures": counts,
           "losses": lcap, "bn_layers": len(m.state.states)}
    if dtype == torch.float32:
        res["mfu_f32_peak"] = flops * sps / FLOPS_PER_S[torch.float32]
    if counts.get("train_step") != 1:
        raise AssertionError(f"{name}: captures {counts}, want one")
    if not all(math.isfinite(x) for x in lcap):
        raise AssertionError(f"{name}: non-finite losses {lcap}")
    log(f"sweep {name} [{card}]: {res['dtype']} batch {batch}, "
        f"{res['params_m']:.2f} M params, {res['bn_layers']} BatchNorm "
        f"layers; 3 captured steps = 3 eager bit for bit (losses {lcap}, "
        f"weights, running stats); step ms median {med:.3f} range "
        f"{min(ms):.3f}-{max(ms):.3f} over {SWEEP_WINDOWS} windows of "
        f"{SWEEP_STEPS}, {sps:.1f} samples/s, MFU {res['mfu_bf16_peak']:.4f}"
        f" of the bf16 peak ({flops / 1e9:.3f} GFLOP a sample), peak "
        f"memory {res['peak_mem_gib']:.2f} GiB")
    del m
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


def seq2seq_lstm_check(ls):
    """Kernels 7 and 8 against their plain versions at the seq2seq's
    shapes (T=20, B=64, H=512; f32 and bf16)."""
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")

    def put(shape, scale):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * scale).to(dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        t, b, h = S2S_T, S2S_B, S2S_H
        errs, _ = lstm_check(ls, put((t, b, 4 * h), 0.5).to(dtype),
                             put((h, 4 * h), 0.03).to(dtype),
                             put((b, h), 0.3), put((b, h), 0.3),
                             put((t, b, h), 1.0).to(dtype),
                             f"seq2seq {dtype} T={t} B={b} H={h}")
        out["f32" if dtype == torch.float32 else "bf16"] = errs
    return out


def seq2seq_scan_parity(ls, dtype):
    """3 seq2seq steps (batch 64, full width) through the LSTM kernels
    against 3 on the scan cell, every weight's gradient held between the
    two (the NMT phase's limits)."""
    batches = sweep_batches("seq2seq", SWEEP["seq2seq"][2], 3, seed=3)

    def steps(use_pallas):
        import flexflow_tpu_torch as ft
        kw = {"dtype": dtype} if dtype != torch.float32 else {}
        m = ft.build_nmt_seq2seq(ft.FFConfig(batch_size=64, seed=0),
                                 batch_size=64, use_pallas=use_pallas,
                                 device="cuda", **kw)
        m.compile(optimizer=ft.SGDOptimizer(lr=0.01), metrics=[],
                  capture=False)
        return record_steps(m, batches)

    lk, gk = steps(None)
    lp, gp = steps(False)
    errs = grad_errs(gk, gp)
    worst = max(errs, key=errs.get)
    limit = NMT_GRAD_REL[dtype]
    loss_tol = NMT_F32_LOSS_REL if dtype == torch.float32 \
        else NMT_BF16_LOSS_REL
    if not all(abs(a - b) <= loss_tol * abs(b) for a, b in zip(lk, lp)):
        raise AssertionError(f"seq2seq {dtype} losses kernel {lk} vs plain "
                             f"{lp}")
    if not errs[worst] <= limit:
        raise AssertionError(f"seq2seq {dtype} gradient of {worst} differs "
                             f"by {errs[worst]} > {limit}")
    lstm = {n: e for n, e in errs.items() if "_lstm_" in n}
    log(f"seq2seq {dtype}: losses kernel {lk} scan {lp}; LSTM gradient "
        f"errors { {n: f'{e:.3g}' for n, e in lstm.items()} }, worst of "
        f"all {errs[worst]:.3g} at {worst} (limit {limit})")
    return {"losses_kernel": lk, "losses_scan": lp,
            "worst_grad_rel": errs[worst], "lstm_grad_rel": lstm}


def sweep_phase(ls, card: str):
    """Each SWEEP model: CPU parity and knobs at batch 4, then its main
    path (captured = eager bit for bit, timed). The seq2seq adds its
    LSTM kernel checks and counts their launches on its main path. cuDNN
    runs deterministic and without autotuning here: a capture cannot
    autotune, and a captured step must equal the eager one bit for
    bit."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out, s2s_launches, fails = {}, None, []
    for name in SWEEP:
        t0 = time.perf_counter()
        p, f = sweep_parity(name)
        fails += f
        res = {"parity": p}
        w = p["ulp_witness"]
        log(f"sweep {name}: card f32 step vs CPU (batch 4): loss "
            f"{p['loss_card']} vs {p['loss_cpu']} (rel {p['loss_rel']:.3g},"
            f" limit {CPU_LOSS_REL}), update rel {p['update_rel']:.3g} "
            f"(limit {p['limits']['update_rel']:.3g}), worst weight "
            f"{p['worst_weights'][0][0]} {p['worst_weights'][0][1]:.3g} "
            f"(limit {p['limits']['each']:.3g}), running stats rel "
            f"{p['states_rel']} (limit {p['limits']['states_rel']:.3g}); "
            f"the CPU's one-ulp witness: update rel "
            f"{w['update_rel']:.3g}, worst weight "
            f"{w['worst_weights'][0][1]:.3g}, running stats rel "
            f"{w['states_rel']}, loss rel {w['loss_rel']:.3g}; knobs "
            f"{ {k: p[k] for k in ('nhwc', 'no_sibling_fusion') if k in p} }"
            f" ({p['sibling_groups']} sibling groups)")
        if name == "seq2seq":
            res["lstm_kernels"] = seq2seq_lstm_check(ls)
            res["scan_parity"] = {
                str(d).replace("torch.", ""): seq2seq_scan_parity(ls, d)
                for d in (torch.float32, torch.bfloat16)}
        res["main"], launches = sweep_main(
            name, card, ls if name == "seq2seq" else None)
        if name == "seq2seq":
            s2s_launches = launches
            steps = 3 + SWEEP_WINDOWS * SWEEP_STEPS
            # 4 LSTM layers a step (the capturing call's own run counts,
            # the capture does not, each replay does)
            want = 4 * steps
            if launches[0] != {"lstm_fwd": want, "lstm_bwd": want}:
                raise AssertionError(f"seq2seq lstm launches {launches[0]}"
                                     f" != 4 layers x {steps} steps")
        res["phase_s"] = time.perf_counter() - t0
        out[name] = res
    if fails:
        log(json.dumps({"sweep": out}))
        raise AssertionError("; ".join(fails))
    return out, s2s_launches


# DLRM at bench.py's "full" preset (bench.py:205-229): 26 tables of
# 1,000,000 x 64 f32 (6.66 GB), batch 8192, 13 dense features, bag 1,
# bottom MLP 512-256-64, top MLP 512-256-1, SGD lr 0.01, MSE, metrics
# off, ids uniform over each table as bench.py draws them. The CPU
# parity runs at its "small" preset (26 x 100,000, batch 2048)
DLRM_FULL = dict(tables=26, vocab=1_000_000, batch=8192)
DLRM_SMALL = dict(tables=26, vocab=100_000, batch=2048)
DLRM_DIM = 64
DLRM_WINDOWS, DLRM_STEPS = 3, 10
# the sparse-row kernel's checks: 8192 ids a table drawn from 1000 rows
# (about 8 occurrences a row) with -1, -V and V among them
DLRM_DUP_ROWS = 1000
# the card's f32 step against the CPU's at DLRM_SMALL, the same weights
# and batch: the loss to 1e-5 relative; the update of all weights, and
# of each (relative to its own norm or UPDATE_FLOOR of the largest), to
# 1e-2. On the card the forward agrees with a float64 CPU run to 1e-7
# and each backward product with float64 products of the card's own
# inputs to 2e-7, but a ReLU input within that rounding of 0 flips its
# mask, and each flip moves one sample's gradient whole: the first chip
# run read the update 1.6e-3 off (worst weight 3.8e-3) where the CPU's
# f32 step sits 4e-7 from float64 (chip diagnostics, PR 12). A wrong
# row rule (no update, another lr, the sign) reads 1 or more
DLRM_CPU_LOSS_REL = 1e-5
DLRM_UPDATE_REL = 1e-2
# MoE: build_moe_fused at batch 1024 ("auto" takes the sorted dispatch:
# 2048 slots x 8 experts x capacity 512 > 2^22 mask elements) and 256
# (dense), build_moe_reference at 1024 (sorted); SGD lr 0.01, 784-wide
# inputs and labels from a numpy seed. "dense" against "sorted" on the
# same weights and batches, 3 steps: the one-hot mask contractions hold
# one nonzero term each, so the two routings give the same sums; limit
# 1e-6 relative on losses and 1e-6 absolute on weights
MOE_CELLS = (("fused", 1024), ("fused", 256), ("reference", 1024))
MOE_PATH_LOSS_REL = 1e-6
MOE_PATH_WEIGHT_ABS = 1e-6
MOE_WINDOWS, MOE_STEPS = 3, 20


def dlrm_model(tables, vocab, batch, stacked=False, device="cuda",
               capture=True, sparse=True):
    """bench.py's DLRM on ``device``, weights from the port's numpy
    streams of seed 0 (the same on every device)."""
    import flexflow_tpu_torch as ft
    m = ft.build_dlrm(ft.FFConfig(batch_size=batch, seed=0,
                                  sparse_embedding_updates=sparse),
                      batch_size=batch, embedding_vocab_sizes=(vocab,)
                      * tables, embedding_dim=DLRM_DIM,
                      stacked_tables=stacked, device=device)
    m.compile(optimizer=ft.SGDOptimizer(lr=0.01),
              loss_type="mean_squared_error", metrics=[], capture=capture)
    return m


def host_weights(m):
    """Host copies of a model's weights, one tensor at a time (a full
    device copy of DLRM's tables would double their memory)."""
    return {f"{op}.{k}": w.detach().cpu()
            for op, p in m.state.params.items() for k, w in p.items()}


def dlrm_batches(tables, vocab, batch, n, seed=0):
    """n host batches as bench.py draws them: normal dense features,
    binary labels, ids uniform over each table."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"dense_features": rng.standard_normal((batch, 13), np.float32),
             "label": (rng.random((batch, 1)) > 0.5).astype(np.float32)}
        for i in range(tables):
            b[f"sparse_{i}"] = rng.integers(0, vocab, (batch, 1)) \
                .astype(np.int32)
        out.append(b)
    return out


SPARSE_RULES = (("exact", 0, (), 0), ("momentum", 1, (0.9,), 1),
                ("nesterov", 2, (0.9,), 1),
                ("adam", 3, (0.9, 1 - 0.9, 0.999, 1 - 0.999, 1e-8), 2))


def sparse_rows_inputs(sr, t, vocab, n, seed, dup, lazy):
    """(w, g, skey, order, scalar, rows touched) on the card: t tables of
    vocab x 64, n ids a table — uniform (the main path's) or, with
    ``dup``, from DLRM_DUP_ROWS rows with -1, -vocab and vocab among
    them."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((t, vocab, DLRM_DIM), generator=gen, device="cuda")
    g = torch.randn((t, n, DLRM_DIM), generator=gen, device="cuda") * 0.1
    if dup:
        ids = rng.integers(0, DLRM_DUP_ROWS, (t, n))
        ids[:, ::97], ids[:, ::89], ids[:, ::83] = -1, vocab, -vocab
    else:
        ids = rng.integers(0, vocab, (t, n))
    ids_t = torch.from_numpy(ids.astype(np.int32)).cuda()
    skey, order = sr.sort_rows(ids_t, vocab, lazy)
    touched = int(sum(len(np.unique(r[(r >= -vocab) & (r < vocab)]
                                    % vocab)) for r in ids))
    scalar = torch.tensor(0.01, dtype=torch.float32, device="cuda")
    return w, g, ids_t, skey, order, scalar, touched


def sparse_rows_check(sr):
    """The kernel against its plain version bit for bit on the card, on
    ids with many duplicates and out-of-range ids: every rule on one
    table at the separate-table path's shape (1,000,000 x 64, 8192 ids),
    the exact rule on the stacked path's (26 tables of it)."""
    out = {}
    v, n = DLRM_FULL["vocab"], DLRM_FULL["batch"]
    cases = [(name, rule, hyper, ns, 1) for name, rule, hyper, ns
             in SPARSE_RULES] + [("exact stacked", 0, (), 0,
                                  DLRM_FULL["tables"])]
    for name, rule, hyper, nslots, t in cases:
        w, g, _, skey, order, scalar, _ = sparse_rows_inputs(
            sr, t, v, n, seed=rule + 7 * t, dup=True, lazy=rule != 0)
        gen = torch.Generator(device="cuda").manual_seed(3)
        slots = [torch.randn(w.shape, generator=gen, device="cuda")
                 for _ in range(nslots)]
        if rule == 3:
            slots[1].abs_()
        wk, sk = w.clone(), [s.clone() for s in slots]
        sr.apply_rows_cuda(wk, skey, order, g, rule, scalar, hyper, sk)
        sr.apply_rows_ref(w, skey, order, g, rule, scalar, hyper, slots)
        torch.cuda.synchronize()
        diffs = [float((a - b).abs().max()) for a, b in
                 zip([wk] + sk, [w] + slots)]
        same = all(torch.equal(a, b) for a, b in zip([wk] + sk,
                                                      [w] + slots))
        if not same:
            raise AssertionError(f"sparse_rows {name}: kernel differs from "
                                 f"its plain version (max abs {diffs})")
        out[name] = {"tables": t, "max_abs_err": max(diffs),
                     "bit_equal": True}
        del w, g, wk, sk, slots
        torch.cuda.empty_cache()
    log(f"sparse_rows: kernel = plain version bit for bit on "
        f"{DLRM_DUP_ROWS}-row duplicate ids with -1, -V, V: "
        f"{', '.join(out)} (1 or {DLRM_FULL['tables']} tables of "
        f"{v} x {DLRM_DIM}, {n} ids a table)")
    return out


def sparse_rows_time(sr, t):
    """The exact rule at the main path's input (t tables of 1,000,000 x
    64, 8192 uniform ids each, keys sorted beforehand): the kernel, its
    plain version, and index_add_ of the same rows (atomics, no fixed
    order: the library yardstick) in 3 interleaved rounds, beside the
    bound: each touched row read and written once, the gradient rows,
    keys and permutation read once, at the HBM rate."""
    v, n = DLRM_FULL["vocab"], DLRM_FULL["batch"]
    w, g, ids, skey, order, scalar, touched = sparse_rows_inputs(
        sr, t, v, n, seed=5, dup=False, lazy=False)
    flat = w.view(t * v, DLRM_DIM)
    gid = (ids.long() + torch.arange(t, device="cuda")[:, None] * v) \
        .reshape(-1)
    upd = (-scalar * g).reshape(-1, DLRM_DIM)
    rounds = yardstick({
        "kernel": lambda: sr.apply_rows_cuda(w, skey, order, g, 0, scalar),
        "plain": lambda: sr.apply_rows_ref(w, skey, order, g, 0, scalar),
        "library": lambda: flat.index_add_(0, gid, upd)}, iters=5)
    nbytes = (2 * touched * DLRM_DIM * 4 + g.numel() * 4
              + 2 * skey.numel() * 8)
    b_ms, b_by = bound(nbytes, 2.0 * g.numel(), torch.float32)
    med = {k: statistics.median(x) for k, x in rounds.items()}
    res = {"tables": t, "ids": n, "rows_touched": touched,
           "ms": med["kernel"], "plain_ms": med["plain"],
           "library_ms": med["library"], "bound_ms": b_ms,
           "bound_by": b_by, "ms_rounds": rounds["kernel"],
           "library_ms_rounds": rounds["library"]}
    log(f"sparse_rows exact, {t} x {v} x {DLRM_DIM}, {n} ids a table: "
        f"kernel {spread(rounds['kernel'])} ms, plain "
        f"{spread(rounds['plain'])}, index_add_ {spread(rounds['library'])}"
        f", bound {b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB)")
    del w, g, flat, upd
    torch.cuda.empty_cache()
    return res


def dlrm_main(sr, card: str, stacked: bool):
    """The main path at full shape: 3 eager steps against 3 captured
    ones bit for bit (losses, every table and weight), then 3 windows of
    DLRM_STEPS captured steps with sparse updates, then the same model
    with ``sparse_embedding_updates`` off (the dense table update:
    captured anew) for as many. The kernel's counts are zeroed just
    before the captured model runs and read before the dense windows."""
    f = DLRM_FULL
    host = dlrm_batches(f["tables"], f["vocab"], f["batch"], 3, seed=2)
    eager = dlrm_model(stacked=stacked, capture=False, **f)
    dev = [eager.executor.shard_batch(b) for b in host]
    le = [float(eager.train_batch(b)["loss"]) for b in dev]
    we = host_weights(eager)       # on the host: out of the peak below
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    sr.launches.update(dict.fromkeys(sr.launches, 0))
    t0 = time.perf_counter()
    m = dlrm_model(stacked=stacked, **f)
    init_s = time.perf_counter() - t0
    # peak memory over the capturing step: a replay allocates nothing,
    # its working set stays in the graph's pool
    torch.cuda.reset_peak_memory_stats()
    lc = [float(m.train_batch(b)["loss"]) for b in dev]
    peak = torch.cuda.max_memory_allocated()
    wdiff = max_weight_diff(we, host_weights(m))
    if lc != le or wdiff[0] != 0.0:
        raise AssertionError(f"dlrm stacked={stacked}: captured steps differ "
                             f"from eager: losses {lc} vs {le}, weights "
                             f"{wdiff}")
    del we
    gc.collect()
    torch.cuda.empty_cache()
    ms = timed_windows(m, dev[0], DLRM_WINDOWS, DLRM_STEPS)
    launches = dict(sr.launches)
    tables = 1 if stacked else f["tables"]
    want = tables * (3 + DLRM_WINDOWS * DLRM_STEPS)
    if launches != {"sparse_rows_exact": want, "sparse_rows_lazy": 0}:
        raise AssertionError(f"dlrm stacked={stacked}: sparse_rows launches "
                             f"{launches}, want {want} exact")
    m.config.sparse_embedding_updates = False
    torch.cuda.reset_peak_memory_stats()
    float(m.train_batch(dev[0])["loss"])       # captures the dense step
    peak_dense = torch.cuda.max_memory_allocated()
    ms_dense = timed_windows(m, dev[0], DLRM_WINDOWS, DLRM_STEPS)
    if dict(sr.launches) != launches:
        raise AssertionError("the dense path launched sparse_rows")
    counts = m.compile_counts()
    if counts.get("train_step") != 2:
        raise AssertionError(f"dlrm captures {counts}: want one a routing")
    if not all(math.isfinite(x) for x in lc):
        raise AssertionError(f"dlrm: non-finite losses {lc}")
    b = f["batch"]
    med, med_d = statistics.median(ms), statistics.median(ms_dense)
    res = {"stacked": stacked, "batch": b, "init_s": init_s,
           "table_gb": f["tables"] * f["vocab"] * DLRM_DIM * 4 / 1e9,
           "losses": lc, "launches": launches, "captures": counts,
           "sparse": {"step_ms": med, "step_ms_range": [min(ms), max(ms)],
                      "step_ms_windows": ms, "samples_per_s": b * 1e3 / med,
                      "peak_mem_gib": peak / 2**30},
           "dense": {"step_ms": med_d,
                     "step_ms_range": [min(ms_dense), max(ms_dense)],
                     "step_ms_windows": ms_dense,
                     "samples_per_s": b * 1e3 / med_d,
                     "peak_mem_gib": peak_dense / 2**30}}
    log(f"dlrm {'stacked' if stacked else 'separate'} [{card}]: "
        f"{f['tables']} x {f['vocab']} x {DLRM_DIM} f32 "
        f"({res['table_gb']:.2f} GB), batch {b}; 3 captured steps = 3 "
        f"eager bit for bit (losses {lc}, every table and weight); sparse "
        f"updates: step ms median {med:.3f} range {min(ms):.3f}-"
        f"{max(ms):.3f} over {DLRM_WINDOWS} windows of {DLRM_STEPS}, "
        f"{b * 1e3 / med:.0f} samples/s, peak {peak / 2**30:.2f} GiB, "
        f"sparse_rows launches {launches}; dense updates: step ms median "
        f"{med_d:.3f} range {min(ms_dense):.3f}-{max(ms_dense):.3f}, "
        f"{b * 1e3 / med_d:.0f} samples/s, peak {peak_dense / 2**30:.2f} "
        f"GiB")
    del m, dev
    gc.collect()
    torch.cuda.empty_cache()
    return res


def dlrm_cpu_parity():
    """One f32 step on the card against the port's CPU step at
    DLRM_SMALL (the same weights and batch): the loss, the update of all
    weights and of each."""
    s = DLRM_SMALL
    batch = dlrm_batches(s["tables"], s["vocab"], s["batch"], 1, seed=1)[0]
    cpu = dlrm_model(device="cpu", **s)
    w0 = {n: w.float().clone() for n, w in weights_of(cpu).items()}
    t0 = time.perf_counter()
    stc = one_step(cpu, batch)
    cpu_s = time.perf_counter() - t0
    del cpu
    card = dlrm_model(capture=False, **s)
    same = max_weight_diff({n: w.cuda() for n, w in w0.items()},
                           weights_of(card))
    if same[0] != 0.0:
        raise AssertionError(f"dlrm: card and CPU initial weights differ "
                             f"{same}")
    stg = one_step(card, batch)
    del card
    torch.cuda.empty_cache()
    res = {"cpu_step_s": cpu_s, "loss_card": stg[0], "loss_cpu": stc[0],
           **compare_steps(w0, {}, stg, stc),
           "limits": {"loss_rel": DLRM_CPU_LOSS_REL,
                      "update_rel": DLRM_UPDATE_REL,
                      "each": DLRM_UPDATE_REL}}
    log(f"dlrm card f32 step vs CPU ({s['tables']} x {s['vocab']}, batch "
        f"{s['batch']}): loss {stg[0]} vs {stc[0]} (rel "
        f"{res['loss_rel']:.3g}, limit {DLRM_CPU_LOSS_REL}), update rel "
        f"{res['update_rel']:.3g}, worst weight "
        f"{res['worst_weights'][0][0]} {res['worst_weights'][0][1]:.3g} "
        f"(limits {DLRM_UPDATE_REL}); CPU step {cpu_s:.2f} s")
    if not (res["loss_rel"] <= DLRM_CPU_LOSS_REL
            and res["update_rel"] <= DLRM_UPDATE_REL
            and res["worst_weights"][0][1] <= DLRM_UPDATE_REL):
        raise AssertionError(f"dlrm card vs CPU past the limits: {res}")
    return res


def dlrm_phase(sr, card: str):
    """The sparse-row kernel's checks and times, the CPU parity, then
    the separate-table and stacked main paths at full shape."""
    t0 = time.perf_counter()
    res = {"kernel_checks": sparse_rows_check(sr),
           "kernel_time": {"separate": sparse_rows_time(sr, 1),
                           "stacked": sparse_rows_time(
                               sr, DLRM_FULL["tables"])},
           "cpu_parity": dlrm_cpu_parity()}
    res["separate"] = dlrm_main(sr, card, stacked=False)
    res["stacked"] = dlrm_main(sr, card, stacked=True)
    res["phase_s"] = time.perf_counter() - t0
    return res


def moe_model(kind, batch, capture=True, mode="auto"):
    import flexflow_tpu_torch as ft
    build = ft.build_moe_fused if kind == "fused" \
        else ft.build_moe_reference
    m = build(ft.FFConfig(batch_size=batch, seed=0, moe_dispatch=mode),
              batch_size=batch, device="cuda")
    m.compile(optimizer=ft.SGDOptimizer(lr=0.01),
              loss_type="sparse_categorical_crossentropy", metrics=[],
              capture=capture)
    return m


def moe_batches(batch, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input": rng.standard_normal((batch, 784), np.float32),
             "label": rng.integers(0, 10, batch).astype(np.int32)}
            for _ in range(n)]


def moe_sorted(m):
    """The dispatch path a MoE model's routing op takes."""
    from flexflow_tpu_torch.ops.moe import use_sorted_dispatch
    for op in m.ops:
        if op.op_type == "moe_ffn":
            return op.sorted_path()
        if op.op_type == "group_by":
            return use_sorted_dispatch(m, op.k * op.inputs[0].shape[0],
                                       op.n, op.capacity)
    raise AssertionError("no MoE routing op")


def moe_phase(card: str):
    """Each MOE_CELLS model: 3 eager steps against 3 captured ones bit
    for bit, "dense" against "sorted" routing (eager, 3 steps), then 3
    windows of MOE_STEPS captured steps."""
    out = {}
    for kind, batch in MOE_CELLS:
        host = moe_batches(batch, 3, seed=4)
        runs = {}
        for mode in ("dense", "sorted"):
            m = moe_model(kind, batch, capture=False, mode=mode)
            dev = [m.executor.shard_batch(b) for b in host]
            runs[mode] = ([float(m.train_batch(b)["loss"]) for b in dev],
                          weights_of(m))
            del m
        (ld, wd), (ls_, ws) = runs["dense"], runs["sorted"]
        path_loss = max(abs(a - b) / abs(b) for a, b in zip(ld, ls_))
        path_w = max_weight_diff(wd, ws)
        if not (path_loss <= MOE_PATH_LOSS_REL
                and path_w[0] <= MOE_PATH_WEIGHT_ABS):
            raise AssertionError(f"moe {kind} b={batch}: dense vs sorted "
                                 f"losses {ld} vs {ls_}, weights {path_w}")
        eager = moe_model(kind, batch, capture=False)
        le = [float(eager.train_batch(b)["loss"]) for b in dev]
        we = weights_of(eager)
        del eager
        m = moe_model(kind, batch)
        lc = [float(m.train_batch(b)["loss"]) for b in dev]
        wdiff = max_weight_diff(we, weights_of(m))
        if lc != le or wdiff[0] != 0.0:
            raise AssertionError(f"moe {kind} b={batch}: captured steps "
                                 f"differ from eager: losses {lc} vs {le}, "
                                 f"weights {wdiff}")
        if not all(math.isfinite(x) for x in lc):
            raise AssertionError(f"moe {kind}: non-finite losses {lc}")
        ms = timed_windows(m, dev[0], MOE_WINDOWS, MOE_STEPS)
        med = statistics.median(ms)
        res = {"batch": batch, "sorted_dispatch": moe_sorted(m),
               "losses": lc, "dense_vs_sorted_loss_rel": path_loss,
               "dense_vs_sorted_weight_abs": path_w[0],
               "step_ms": med, "step_ms_range": [min(ms), max(ms)],
               "step_ms_windows": ms, "samples_per_s": batch * 1e3 / med,
               "captures": m.compile_counts()}
        log(f"moe {kind} [{card}] batch {batch} ("
            f"{'sorted' if res['sorted_dispatch'] else 'dense'} dispatch "
            f"under auto): 3 captured steps = 3 eager bit for bit (losses "
            f"{lc}); dense vs sorted: loss rel {path_loss:.3g}, weights "
            f"{path_w[0]:.3g} (limits {MOE_PATH_LOSS_REL}, "
            f"{MOE_PATH_WEIGHT_ABS}); step ms median {med:.3f} range "
            f"{min(ms):.3f}-{max(ms):.3f}, {res['samples_per_s']:.0f} "
            f"samples/s")
        out[f"{kind} b={batch}"] = res
        del m, dev
        gc.collect()
        torch.cuda.empty_cache()
    want = {("fused", 1024): True, ("fused", 256): False,
            ("reference", 1024): True}
    got = {(k, b): out[f"{k} b={b}"]["sorted_dispatch"] for k, b in want}
    if got != want:
        raise AssertionError(f"moe auto dispatch {got}, want {want}")
    return out


def _kernel_name(sym: str) -> str:
    """A mangled kernel symbol as name[template args, still mangled]:
    the name is the length-prefixed identifier ending in _kernel."""
    for m in re.finditer(r"\d+", sym):
        end = m.end()
        for i in range(len(m.group())):   # the length may follow a hash
            n = int(m.group()[i:])
            name = sym[end:end + n]
            if name.endswith("_kernel"):
                rest = sym[end + n:]
                return f"{name}[{rest[:rest.find('EE') + 2]}]"
    return sym


def ptxas_usage(text: str):
    """(kernel, registers, spill stores/loads) per kernel from nvcc's
    -Xptxas=-v output."""
    out, kernel = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            kernel = _kernel_name(m.group(1))
            spill = None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append((kernel, int(m.group(1)), spill))
            kernel = None
    return out


def sass_mma_counts(name):
    """{kernel: HMMA (tensor-core) instructions} in the SASS of the
    built library of csrc/<name>.cu, read with cuobjdump from nvcc's
    toolkit; None where the toolkit has no cuobjdump."""
    from flexflow_tpu_torch.kernels import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    run = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                         capture_output=True, text=True)
    if run.returncode != 0:
        log(f"sass {name}: cuobjdump failed: {run.stderr.strip()[-500:]}")
        return None
    out = run.stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = _kernel_name(m.group(1))
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    return counts


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
    from flexflow_tpu_torch.kernels import dropout as kd
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import lstm_scan as ls
    from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr
    from flexflow_tpu_torch.kernels import sparse_rows as sr

    t_start = time.perf_counter()
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
    usage = {}
    for name, text in logs.items():
        for kernel, regs, spill in ptxas_usage(text):
            usage[kernel] = {"registers": regs, "spill_stores_loads": spill}
            log(f"  {name}: {kernel}: {regs} registers, spill "
                f"stores/loads {spill}")
    # the bf16 flash backward on the tensor cores must not spill at d=64
    bwd64 = [k for k in usage
             if k.startswith("flash_bwd_") and "_mma_kernel[ILi64E" in k]
    if sorted(k[:k.index("[")] for k in bwd64) != [
            "flash_bwd_dkv_mma_kernel", "flash_bwd_dq_mma_kernel"]:
        raise AssertionError(f"ptxas usage holds {bwd64}, not the two bf16 "
                             f"flash backward kernels at d=64")
    spilled = [k for k in bwd64 if usage[k]["spill_stores_loads"] != "0/0 B"]
    if spilled:
        raise AssertionError(f"bf16 flash backward spills at d=64: "
                             f"{ {k: usage[k] for k in spilled} }")
    # nor may the bf16 LSTM forward step, any instantiation of kernel 1's
    # query-tile kernel, the split decode kernel (kernels 5, 6) or the
    # wide-head decode kernel
    added = [k for k in usage if k.startswith((
        "lstm_fwd_step_mma_kernel[", "ragged_v2_tile_kernel[",
        "paged_decode_split_kernel[", "paged_decode_wide_kernel["))]
    if sorted({k[:k.index("[")] for k in added}) != [
            "lstm_fwd_step_mma_kernel", "paged_decode_split_kernel",
            "paged_decode_wide_kernel", "ragged_v2_tile_kernel"]:
        raise AssertionError(f"ptxas usage lacks a kernel of those: "
                             f"{added}")
    spilled = [k for k in added if usage[k]["spill_stores_loads"] != "0/0 B"]
    if spilled:
        raise AssertionError(f"kernels spill: "
                             f"{ {k: usage[k] for k in spilled} }")
    split = [k for k in added if k.startswith("paged_decode_split_kernel[")]
    log(f"no spills in the bf16 flash backward at d=64 ({len(bwd64)} "
        f"kernels), the LSTM forward step, kernel 1 or the decode kernels "
        f"({len(added)}: {max(usage[k]['registers'] for k in added)} "
        f"registers at most; paged_decode_split_kernel {len(split)} "
        f"instantiations, {min(usage[k]['registers'] for k in split)}-"
        f"{max(usage[k]['registers'] for k in split)} registers)")
    # the bf16 paths of kernels 2, 3, 4, 7 and 8 run on the tensor cores:
    # their kernels (*_mma_kernel) must hold HMMA instructions
    hmma = {}
    for name, want in (("flash_attention", ("flash_fwd_mma_kernel",
                                            "flash_bwd_dq_mma_kernel",
                                            "flash_bwd_dkv_mma_kernel")),
                       ("lstm_scan", ("lstm_fwd_step_mma_kernel",
                                      "lstm_bwd_step_mma_kernel",
                                      "lstm_dh0_mma_kernel",
                                      "lstm_dwh_mma_kernel"))):
        counts = sass_mma_counts(name)
        if counts is None:
            log(f"sass {name}: no cuobjdump beside nvcc, HMMA not counted")
            continue
        hmma.update(counts)
        log(f"sass {name}: HMMA instructions per kernel {counts}")
        bare = [k for k, n in counts.items() if "_mma_kernel" in k and not n]
        missing = [w for w in want
                   if not any(k.startswith(w + "[") for k in counts)]
        if bare or missing:
            raise AssertionError(f"{name}: tensor-core kernels without "
                                 f"HMMA in SASS: {bare + missing}")

    kres = kernel_phase(pr)
    dres = paged_decode_phase(fa)
    fres = flash_phase(fa)
    hres = head_dim_phase(fa, pr)
    tres = train_phase(fa, card)
    lmres, lm = lm_train_phase(fa, card)
    lres = lstm_phase(ls)
    nres = nmt_train_phase(ls, card)
    sres = serve_phase(pr, fa, card, lm)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    fitres, drop_launches = fit_loop_phase(kd, fa, card)
    dres_f = dropout_phase(kd)
    swres, s2s_launches = sweep_phase(ls, card)
    dlres = dlrm_phase(sr, card)
    moeres = moe_phase(card)

    def head(cells):
        """A row's headline numbers: its f32 cell."""
        f32 = cells["f32"]
        return {"max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
                "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
                "bound_by": f32["bound_by"], "library_ms": None}

    # the int8/fp8 cells carry the launches of their own serving runs
    for cell in ("int8", "fp8"):
        kres[cell]["launches"] = sres[cell][0]["paged_ragged_v2"]
    decode_src = "flexflow_tpu_torch/kernels/csrc/paged_decode.cu"
    rows = [{
        "name": "paged_ragged_v2", "route": "cuda",
        "source": "flexflow_tpu_torch/kernels/csrc/paged_ragged_v2.cu",
        "replaces": "flexflow_tpu/kernels/paged_ragged_v2.py:245",
        "launches": sres["f32"][0]["paged_ragged_v2"], **head(kres),
        "bf16": kres["bf16"], "int8": kres["int8"], "fp8": kres["fp8"]}, {
        "name": "paged_decode", "route": "cuda", "source": decode_src,
        "replaces": "flexflow_tpu/kernels/flash_attention.py:390",
        "launches": sres["legacy_f32"][0]["paged_decode"],
        **head(dres["paged_decode"]),
        "shapes": dres["paged_decode"]["f32"]["shapes"],
        "bf16": dres["paged_decode"]["bf16"]},
        {
        "name": "paged_ragged_v1", "route": "cuda", "source": decode_src,
        "replaces": "flexflow_tpu/kernels/flash_attention.py:413",
        "launches": dres["v1_launches"], **head(dres["paged_ragged_v1"]),
        "bf16": dres["paged_ragged_v1"]["bf16"],
        "v1_vs_v2_max_abs_err": dres["v1_vs_v2_max_abs_err"]}]
    for row, prefix in zip(rows, ("ragged_v2_tile_kernel[",
                                  "paged_decode_", "paged_decode_")):
        row["head_dims"] = {k: e for k, e in hres.items()
                            if k.startswith(row["name"] + " ")}
        row["ptxas"] = {k: u for k, u in usage.items()
                        if k.startswith(prefix)}
    # the flash rows' headline is the training path's own cell (bf16,
    # not causal); the other three cells ride along
    for kname, line in (("flash_fwd", 67), ("flash_bwd_dq", 131),
                        ("flash_bwd_dkv", 161)):
        cells = fres[kname]
        head = cells["bf16"]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "flexflow_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": f"flexflow_tpu/kernels/flash_attention.py:{line}",
            "launches": tres["launches"][kname],
            "lm_launches": lmres["captured"]["launches"][kname],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "ms_rounds": head["ms_rounds"],
            "library_ms_rounds": head["library_ms_rounds"],
            "sass_hmma": {k: n for k, n in hmma.items()
                          if k.startswith(kname + "_")},
            "ptxas": {k: u for k, u in usage.items()
                      if k.startswith(kname + "_")},
            "head_dims": {k: e for k, e in hres.items()
                          if k.startswith(kname + " ")},
            **{c: v for c, v in cells.items() if c != "bf16"}})
    # the LSTM rows' headline is the NMT path's own cell (bf16); the f32
    # cell rides along. library_ms: cuDNN's layer forward, and its
    # backward alone (its forward + backward beside; see lstm_phase)
    for kname, line in (("lstm_fwd", 65), ("lstm_bwd", 119)):
        cells = lres[kname]
        head = cells["bf16"]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "flexflow_tpu_torch/kernels/csrc/lstm_scan.cu",
            "replaces": f"flexflow_tpu/kernels/lstm_scan.py:{line}",
            "launches": nres["launches"][kname],
            "seq2seq_launches": s2s_launches[0][kname],
            "seq2seq_device_launches": s2s_launches[1][kname],
            "seq2seq_shapes": swres["seq2seq"]["lstm_kernels"],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "port_layer_ms": head["port_layer_ms"],
            "device_launches": nres["device_launches"][kname],
            "ms_rounds": head["ms_rounds"],
            "library_ms_rounds": head["library_ms_rounds"],
            **{k: head[k] for k in ("library_fwd_bwd_ms",
                                    "library_fwd_bwd_ms_rounds")
               if k in head},
            "sass_hmma": {k: n for k, n in hmma.items() if k.startswith(
                ("lstm_fwd_",) if kname == "lstm_fwd"
                else ("lstm_bwd_", "lstm_dh0_", "lstm_dwh_"))},
            "ptxas": {k: u for k, u in usage.items() if k.startswith(
                ("lstm_fwd_",) if kname == "lstm_fwd"
                else ("lstm_bwd_", "lstm_dh0_", "lstm_dwh_"))},
            "f32": cells["f32"], "odd_shape": cells["odd_shape"]})
    # the dropout kernel: no TPU kernel (JAX draws the mask in XLA); the
    # headline cell is the LM path's own (bf16, 16 x 512 x 512)
    for kname in ("dropout_fwd", "dropout_bwd"):
        cells = dres_f[kname]
        head_cell = f"bf16 {'x'.join(map(str, DROPOUT_SHAPES[0]))}"
        rows.append({
            "name": kname, "route": "cuda",
            "source": "flexflow_tpu_torch/kernels/csrc/dropout.cu",
            "replaces": "flexflow_tpu/ops/elementwise.py:205",
            "replaces_note": "jax.random.bernoulli in XLA, no Pallas "
                             "kernel; also ops/attention.py:156",
            "launches": drop_launches[kname], **cells[head_cell],
            "library_note": "torch.nn.functional.dropout: same work, "
                            "another random stream",
            "cells": {c: v for c, v in cells.items() if c != head_cell},
            "ptxas": {k: u for k, u in usage.items()
                      if k.startswith("dropout_")}})
    rows[-1]["fit_loop"] = fitres
    # the sparse-row kernel: no TPU kernel (JAX scatters the rows in XLA);
    # the headline cell is the separate-table path's (one table a launch)
    sep = dlres["kernel_time"]["separate"]
    checks = dlres["kernel_checks"]
    rows.append({
        "name": "sparse_rows", "route": "cuda",
        "source": "flexflow_tpu_torch/kernels/csrc/sparse_rows.cu",
        "replaces": "flexflow_tpu/core/optimizers.py:151",
        "replaces_note": "XLA's scatter in SGDOptimizer.sparse_update "
                         "(exact); the lazy rules at :158 and :231; no "
                         "Pallas kernel",
        "launches": dlres["separate"]["launches"]["sparse_rows_exact"],
        "stacked_launches":
            dlres["stacked"]["launches"]["sparse_rows_exact"],
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        **{k: sep[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "ms_rounds",
                               "library_ms_rounds", "rows_touched")},
        "library_note": "index_add_: the same update with atomics, in no "
                        "fixed order",
        "stacked": dlres["kernel_time"]["stacked"], "checks": checks,
        "ptxas": {k: u for k, u in usage.items()
                  if k.startswith("sparse_rows_")}})
    log(json.dumps({"dlrm": {k: v for k, v in dlres.items()
                             if k not in ("kernel_checks",
                                          "kernel_time")}}))
    log(json.dumps({"moe": moeres}))
    log(json.dumps({"sweep": swres}))
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
