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
  * serves and trains under failure and under telemetry
    (``robust_phase``): the 8 greedy prompts through the captured mixed
    step and legacy path with transient dispatch faults, a cancel and
    an immediate deadline (survivors token-identical to the fault-free
    run, 2 retries, no new capture); a fatal step contained, with a
    post-mortem bundle in JAX's schema and the next batch exact;
    telemetry on against off (the same tokens, captures and host
    synchronizations; step wall and the median paired overhead with its
    spread over 11 interleaved paired rounds; the trace's events and
    the Prometheus counters); the idle share split by the step spans
    into the host gap between steps and the span's excess over device
    time; and fit of the dropout LM below at train_dispatch_depth 0, 1,
    2 with telemetry off and on, masters bit for bit, step time per
    depth, and a profiling.trace() file;
  * serves the same LM beyond one engine (``tier_phase``): the 8
    greedy prompts under LoRA tenants 0-3 (rank 16, one rank 8 padded)
    on f32 and int8 pages, each stream held against its tenant's
    merged-weight reference by the tie rule and the captured engine
    against an eager one, and the LoRA step's wall and device ms by
    class against the base step's; a host tier of 8 MB under two
    alternating working sets on f32 and int8 pages (pages spill and
    reload, tokens those of the tier-off run) and the pinned page-batch
    copy rate beside the priced one; two replicas serving 64 timed
    requests under each router policy, every completed stream equal to
    one engine's, and the prefix-hit pages of each;
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

  * runs the executing mesh (``mesh_phase``, after every earlier
    phase; its ranks are processes spawned after the build, loading the
    parent's kernels): (a) one NCCL rank per visible card trains the
    README's LM (bf16 policy, 16 x 512, captured) on ``default_mesh()``
    with grad_bucket_mb auto, 0 and 25 MB against the same model
    without a mesh — at world 1 the losses and masters bit for bit —
    with step ms beside the no-mesh step, the buckets and the
    collective launches a step; (b) prints NCCL's refusal of two ranks
    on one card, then runs two gloo ranks on it, eager, the dropout LM
    at full width in the f32 policy on (2,) data with ZeRO-1 and on
    (1, 2) data x model under megatron_strategy (kernels 2-4 on 4 of 8
    heads, the dropout kernel at each rank's offset), held against the
    one-rank card run at f32 (MESH_LOSS_REL, MESH_WEIGHT_ABS), every
    rank's flash and dropout launches counted (layers x steps), the
    bytes staged through host memory a step; (c) ``compile(
    search_budget=...)`` of the LM on (b)'s mesh, the winner's
    explain_report head and simulated step beside the measured eager
    step (no speed: gloo stages every collective through the host).

  * serves the README's LM tensor-parallel (``tp_serve_phase``, last):
    two gloo ranks sharing the card each run a t = 2 ``ServeEngine``
    (4 of 8 heads, kernel 1 on them, eager: every collective staged
    through pinned host memory) on the 8 greedy prompts with 32 new
    tokens: (a) f32 pages, the ranks' tokens against this process's
    one-device captured engine (tie rule PARITY_MARGIN), kernel 1's
    launches a rank (layers x steps), the collectives and the bytes
    staged a step beside the engine's analytic collective payload, the
    eager step wall; (b) int8 pages, each rank's codes and scales
    against the one-device engine's rows of its heads by layer (codes
    off by a grid step, which must be at most one; scales' relative
    difference; layers bit for bit), the tokens by the int8 tie rule;
    (c) a 1:1 DisaggCluster of t = 2 roles equal to the t = 2 unified
    engine token for token, and a t = 2 export imported into a
    one-device engine with equal rows; (d) kernel 1 at
    H = 4 and H = 2 (f32, int8 pages) against its plain version, timed
    beside it and its bound. ``--only-tp-serve`` runs the build and
    this phase alone.

  * runs the wall-clock pool at t = 2 over a model kept on the host
    (``pool_tp_phase``, after ``tp_serve_phase``) on two gloo ranks
    sharing the card, eager: (a) each rank boots a pool of two t = 2
    replicas from the README LM built on the host (the card's allocated
    bytes beside each replica's memory ledger: a rank's shards, no whole
    copy) and serves a seeded stream of 16 greedy requests on the wall
    clock in lockstep; the ranks' records equal, the streams against
    this process's one-device captured pool (tie rule PARITY_MARGIN),
    kernel 1's launches a rank (layers x steps), the lockstep calls a
    tick and their wall cost, makespan and goodput (no speed: two gloo
    ranks share the card); (b) the allocator capped at the host pool's
    own peak plus half the whole parameters: the host pool serves the
    stream's first requests under it, the same pool over the LM built
    on the card runs out of memory; (c) kernel 1 at H = 4 (a rank's
    heads), f32 pages, against its plain version. ``--only-pool-tp``
    runs the build and this phase alone.

  * runs sequence parallelism, expert parallelism and placed tables
    (``sp_phase``, last) on two gloo ranks sharing the card, eager:
    (a) the dropout LM at full width on a (1, 2) data x seq mesh under
    sequence_parallel_strategy(), f32 and under the bf16 policy, once
    through the all-to-all core (kernels 2-4 on each rank's 4 of 8
    heads over the whole sequence) and once through the ring, against
    the one-device run of the same weights and keys (f32 at
    MESH_LOSS_REL / MESH_WEIGHT_ABS, bf16 at SP_BF16_LOSS_REL and each
    update within SP_BF16_UPDATE_REL of its own), the flash and dropout
    launches a rank (the dropout kernel on blocks of the sequence: one
    run a row), the collectives and the MiB staged a step; (b) kernels
    2-4 at the all-to-all core's per-rank shape (b=16, s=512, h=4,
    d=64, causal, f32 and bf16) against their plain pieces, timed
    beside their bounds and SDPA; (c) build_moe_fused on (1, 2) data x
    expert against the one-device run; (d) DLRM "full" stacked with
    its 26 tables placed round-robin over the two ranks, sparse
    updates, against the one-device step, each rank holding exactly
    its slots, sparse_rows launches a rank; (e) the NCCL branches of
    the all-to-all and the ring on one NCCL rank at axis size 1.
    ``--only-sp`` runs the build and this phase alone.

  * runs pipelines (``pp_phase``, last) on two gloo ranks sharing the
    card, eager: (a) the README LM auto-cut over a (2,) pipe mesh
    (flops-balanced: the 512 x 32000 head weighs about 4.5 blocks, so
    the cut is uneven; printed), M = 4 microbatches, under GPipe and
    1F1B, f32 against the one-device run of the same weights
    (MESH_LOSS_REL / MESH_WEIGHT_ABS after 2 SGD steps) and the bf16
    policy (PP_BF16_LOSS_REL, PP_BF16_UPDATE_REL); (b) interleaved, v = 2 (4 stages on the
    2 ranks, 1F1B), f32 against the same one-device run; (c) per rank
    its resident parameter and slot bytes against its PackSpec rows,
    its flash launches (its attention layers x M, each direction), the
    sends and receives and the MiB staged a step; (d) kernels 2-4 at
    the microbatch shape (b=4, s=512, h=8, d=64, causal, f32 and bf16)
    against their plain pieces, timed beside their bounds and SDPA; (e)
    the LM's block stacked 6 deep as ``pipeline_blocks`` with ``layer ->
    pipe`` against its one-device loop. ``--only-pp`` runs the build
    and this phase alone.

  * runs ``channel_out`` on conv and LSTM (``channel_phase``, last): (c)
    kernels 7-8 in the split form at a rank's shape (T=40, B=256,
    Hin=1024, Hu=512, f32 and bf16) against their split plain versions,
    the two-block forward stepped in one process against whole-H kernel
    7 bit for bit and the two-block backward against kernel 8, one
    block's walk timed beside the whole-H kernels and cuDNN with its
    bound; then on two gloo ranks sharing the card, eager, (a) the NMT
    at full width on (1, 2) data x model with channel_out on both LSTMs,
    f32 and bf16, 2 steps against the one-rank card run (f32 at
    MESH_LOSS_REL / MESH_WEIGHT_ABS, bf16 at NMT_BF16_LOSS_REL and each
    gradient within NMT_GRAD_REL), each rank's kernel 7/8 walks and
    device kernels, the collectives and MiB staged a step; (b) AlexNet
    at the sweep's shape with channel_out on its convs, f32, against the
    one-rank run; (d) on one NCCL rank, the NMT captured on a model axis
    of one rank bit for bit with the no-mesh step (the whole-H kernels
    run there). ``--only-channel`` runs the build and this phase alone.

  * runs layouts over several mesh axes (``layout_phase``, last) on four
    gloo ranks sharing the card, eager: (a) the README LM at full width
    on (2, 2) data x model with every linear's channel_out, attention's
    head and the embeddings' vocab over ("model", "data") — the FSDP
    layout: a rank stores a quarter of each split weight and runs the
    tensor-parallel rule over model on the weight gathered over data —
    f32 and under the bf16 policy, against the one-device run (f32 at
    MESH_LOSS_REL / MESH_WEIGHT_ABS, bf16 at SP_BF16_LOSS_REL and each
    update within SP_BF16_UPDATE_REL of its own), a rank's resident
    parameter bytes against the whole, the collectives and the MiB
    staged a step, the flash launches a rank; (b) the LM with seq over
    ("seq", "model") on (1, 2, 2) data x model x seq, through the
    all-to-all core (kernels 2-4 on 2 of 8 heads over the whole
    sequence) and the ring, held the same way; (c) kernels 2-4 at (b)'s
    per-rank shape (b=16, s=512, h=2, d=64, causal, f32 and bf16)
    against their plain pieces, timed beside their bounds and SDPA; (d)
    on one NCCL rank, the LM captured on (1, 1) data x model carrying
    (a)'s tuple entries bit for bit with the no-mesh step.
    ``--only-layout`` runs the build and this phase alone.

  * runs the frontends (``frontend_phase``, last), f32 with TF32 off:
    (a) a Keras text classifier at the NMT's full width (Embedding(32000,
    1024) over 40 tokens -> LSTM(1024) x 2 -> Dense(46, softmax), batch
    256, SGD lr 0.01) trained 3 steps by ``keras.Model.fit`` with the
    step captured, its LSTM ops on kernels 7 and 8 and its embedding's
    rows on the sparse-row kernel, launches counted; held against the
    same graph on the scan cell (losses and each weight's gradient at the
    NMT phase's limits, from an eager kernel run that must equal the
    captured one bit for bit), then ``predict`` on 512 rows (kernel 7's
    launches, probabilities and argmax agreement); (b) the same model
    through ``fit(prefetch=True)``, the native row loader against the
    Python one, weights bit for bit, and each loader's host milliseconds
    a batch; (c) the CIFAR-10 CNN of
    ``examples/python/pytorch/cifar10_cnn_torch.py`` (batch 64) imported
    through torch.fx and through ONNX (torch's TorchScript exporter, the
    wire reader), each forward held against the module's own on the card
    at 1e-5, then 3 captured steps each; (d) the host embedding-bag at
    DLRM's width (D 64, bags of 8), native against numpy.
    ``--only-frontend`` runs the build and this phase alone.

Every phase raises on failure. Prints the card (name, power limit), the
build, each kernel's error and times, the training and serving numbers,
the script's wall time, then one line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without CUDA or outside a checkout. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
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


def kernel_inputs(dtype, device, seed=0, heads=HEADS):
    """The mixed step's attention inputs: one sequence's 512-token
    prefill chunk (slot 0, lanes at positions 0..511) plus 8 decode
    lanes (slots 0..7) at lengths spread over 1..512, on page tables
    that map the whole 256-page pool in a shuffled order; ``heads``
    heads (a rank's at t > 1)."""
    rng = np.random.default_rng(seed)
    shape = (NUM_PAGES, PAGE, heads, HEAD_DIM)
    kp = torch.from_numpy(rng.standard_normal(shape, np.float32))
    vp = torch.from_numpy(rng.standard_normal(shape, np.float32))
    tables = rng.permutation(np.arange(1, NUM_PAGES)).reshape(
        MAX_SEQS, PAGES_PER_SEQ).astype(np.int32)
    t = T_PREFILL + MAX_SEQS
    q = torch.from_numpy(rng.standard_normal((t, heads, HEAD_DIM),
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
    heads = kp.shape[-2]
    page_bytes = PAGE * heads * HEAD_DIM * kp.element_size()
    if kp.element_size() == 1:
        page_bytes += PAGE * heads * 4
    nbytes = (2 * len(live) * page_bytes + 2 * q.numel() * q.element_size()
              + tables.numel() * 4
              + (1 if slots is None else 2) * len(l_np) * 4)
    flops = 4.0 * float(l_np.astype(np.int64).sum()) * heads * HEAD_DIM
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


def flash_bounds(dtype, causal, b=TB, h=TH):
    """{kernel: (bound_ms, bound_by)} of the three flash kernels at the
    training shapes, batch ``b``, ``h`` heads. Flops count the (query, key) pairs this run
    computes — all s^2 of them, or the s(s+1)/2 on or below the
    diagonal when causal — at 4d (forward: q.k, p.v), 6d (dq: q.k,
    do.v, ds.k) and 8d (dkv: also p^T.do, ds^T.q) per pair. Bytes read
    each input once and write each output once: (b, s, h, d) operands
    in the input type, lse and delta f32 (b, h, s)."""
    pairs = TS * (TS + 1) / 2 if causal else float(TS * TS)
    per = b * h * TD * pairs
    op = b * TS * h * TD * torch.tensor([], dtype=dtype).element_size()
    row = b * h * TS * 4
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


def lm_model(compute_dtype, use_flash=True, capture=True, mesh=None,
             strategy=None, arch=None, batch=None, **cfg):
    """The LM at full width on the card under ``compute_dtype``'s
    policy (f32 masters). Weights come from the port's numpy streams
    seeded by (config.seed, op, weight), so every model built here
    starts from the same weights. ``use_flash=False`` puts the attention
    ops on the einsum path; ``capture=False`` runs every step eagerly;
    ``mesh``/``strategy`` run it on an executing mesh (``cfg``: more
    FFConfig fields)."""
    from functools import partial
    from flexflow_tpu_torch import FFConfig, SGDOptimizer, build_transformer_lm
    from flexflow_tpu_torch.core.losses import \
        sparse_categorical_crossentropy
    batch = batch or LB
    m = build_transformer_lm(
        FFConfig(batch_size=batch, seed=0, compute_dtype=compute_dtype,
                 **cfg),
        batch_size=batch, device="cuda", mesh=mesh, strategy=strategy,
        **(arch or LM_ARCH))
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


def nmt_graph(dtype, use_pallas=None, **cfg):
    """build_nmt_lstm at full width on the card, not compiled (``cfg``:
    more FFConfig fields)."""
    from flexflow_tpu_torch import FFConfig, build_nmt_lstm
    return build_nmt_lstm(FFConfig(batch_size=NB, seed=0, **cfg),
                          batch_size=NB, seq_len=NT, vocab_size=NV,
                          embed_dim=NH, hidden=NH, num_layers=NL,
                          dtype=dtype, use_pallas=use_pallas, device="cuda")


def nmt_model(dtype, use_pallas, capture=True):
    """build_nmt_lstm at full width on the card, SGD lr 0.01; weights
    from the port's numpy streams, the same for every model built
    here. ``capture=False`` runs every step eagerly."""
    from flexflow_tpu_torch import SGDOptimizer
    m = nmt_graph(dtype, use_pallas)
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
        want_counts.update({"adapter": 0, "export": 0, "import": 0})
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


# ------------------------------------------- robustness and telemetry
# the chaos runs: transient dispatch faults at these hits of the path's
# site (the warmup is hit 1), a cancel at step CHAOS_CANCEL_STEP of the
# request CHAOS_CANCEL_RID, and an immediate deadline on request
# CHAOS_DEADLINE_RID (neither shares the four prompts' preamble)
CHAOS_HITS = "3,6"
CHAOS_CANCEL_RID, CHAOS_CANCEL_STEP, CHAOS_DEADLINE_RID = 5, 4, 1
FATAL_HIT = 5
# telemetry on/off: interleaved paired rounds on each path (the order
# alternating by round); the overhead is the median of the rounds'
# on/off ratios, with their spread
ONOFF_ROUNDS = 11
DEPTHS = (0, 1, 2)
# tools/postmortem.py's schema and required keys (the tool imports JAX)
POSTMORTEM_SCHEMA = "flexflow_tpu.postmortem/1"
POSTMORTEM_KEYS = ("schema", "reason", "created_unix_s", "engine",
                   "compile_counts", "events", "metrics", "drift",
                   "kv_pool", "faults")


class SyncCounter:
    """Counts host synchronizations (torch.cuda.synchronize, and
    Stream.synchronize and Event.synchronize) while active."""

    def __enter__(self):
        self.n = 0
        self._saved = [(torch.cuda, "synchronize"),
                       (torch.cuda.Stream, "synchronize"),
                       (torch.cuda.Event, "synchronize")]
        self._saved = [(o, a, getattr(o, a)) for o, a in self._saved]
        for obj, attr, fn in self._saved:
            def counted(*a, _fn=fn, **k):
                self.n += 1
                return _fn(*a, **k)
            setattr(obj, attr, counted)
        return self

    def __exit__(self, *exc):
        for obj, attr, fn in self._saved:
            setattr(obj, attr, fn)


def device_busy_s(fn):
    """(result of fn(), device busy seconds) under torch.profiler with
    CUDA activity only (the least host overhead it adds)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy = sum(float(e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    return out, busy


def idle_split(events, busy_s):
    """The idle share of a run's steps split by the ported spans (the
    run's telemetry events): the mean host gap BETWEEN consecutive step
    spans (scheduling, emission, bookkeeping), the mean span, and the
    span's excess over the device's busy time a step (``busy_s`` over
    the steps, from the same steps run again under the profiler:
    packing, copies, launch and the wait), each also as a share of the
    step wall (first span start to last span end over the steps)."""
    spans = sorted((e[3], e[4]) for e in events
                   if e[0] == "X" and e[2] == "step")
    n = len(spans)
    window = spans[-1][0] + spans[-1][1] - spans[0][0]
    span_ms = 1e3 * sum(d for _, d in spans) / n
    gap_ms = 1e3 * sum(b[0] - (a[0] + a[1])
                       for a, b in zip(spans, spans[1:])) / (n - 1)
    wall_ms = 1e3 * window / n
    dev_ms = 1e3 * busy_s / n
    return {"steps": n, "step_wall_ms": wall_ms, "span_ms": span_ms,
            "gap_ms": gap_ms, "device_ms": dev_ms,
            "excess_ms": span_ms - dev_ms,
            "gap_share": gap_ms / wall_ms,
            "excess_share": (span_ms - dev_ms) / wall_ms,
            "device_share": dev_ms / wall_ms}


def prom_counters(text):
    """The counter series of a Prometheus text page, as {series: value}."""
    kinds, out = {}, {}
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, fam, kind = ln.split()
            kinds[fam] = kind
        elif ln:
            series, value = ln.rsplit(" ", 1)
            if kinds.get(series.split("{", 1)[0]) == "counter":
                out[series] = float(value)
    return out


def robust_phase(pr, fa, card: str, lm):
    """Serving and training under failure and under telemetry, at the
    trained LM's full width. (1) chaos: the 8 greedy prompts, 32 new
    tokens, transient dispatch faults at hits CHAOS_HITS, one cancel and
    one immediate deadline — survivors token-identical to the
    fault-free captured run, the cancelled stream a prefix of its
    stream, 2 retries, no new capture, invariants clean after every
    step; on the mixed step (serve.mixed) and the legacy path
    (serve.decode). (2) a fatal step: the in-flight requests fail, a
    post-mortem bundle in JAX's schema lands in postmortem_dir, the next
    batch is token-identical, no new capture. (3) telemetry on and off:
    the same tokens, captures and host synchronizations; step wall
    over ONOFF_ROUNDS interleaved runs each and the overhead; the
    trace's events by name; the Prometheus counters. (4) the idle share
    split by the step spans. (5) fit of the bf16-policy LM, 1 epoch of
    FIT_STEPS with prefetch, at train_dispatch_depth 0, 1, 2, telemetry
    on and off: masters bit-equal across all six, one capture; step
    time at each depth; profiling.trace() writes its trace. Returns
    its numbers and the kernel launches of its runs."""
    import tempfile
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import ServeEngine
    from flexflow_tpu_torch.utils import faults, profiling
    from flexflow_tpu_torch.utils.telemetry import Telemetry
    t_phase = time.perf_counter()
    greedy, _ = serve_prompts(LM_ARCH["vocab_size"])
    new = 32
    res, launches = {}, {}
    paths = (("mixed", FFConfig(), "serve.mixed", "paged_ragged_v2"),
             ("legacy", FFConfig(serve_chunked_prefill=False),
              "serve.decode", "paged_decode"))

    def count(kernel):
        return pr.launches if kernel == "paged_ragged_v2" \
            else fa.launches["paged_decode"]

    def zero():
        pr.launches = 0
        fa.launches["paged_decode"] = 0

    for path, cfg, site, kernel in paths:
        off = ServeEngine(lm, cfg, device="cuda")
        on = ServeEngine(lm, cfg, device="cuda", telemetry=Telemetry())
        counts = off.warmup()
        if on.warmup() != counts:
            raise AssertionError(f"{path}: captures on {on.compile_counts()}"
                                 f" != off {counts}")
        ref = off.generate(greedy, new)
        if on.generate(greedy, new) != ref:
            raise AssertionError(f"{path}: telemetry on changes the tokens")
        # (3) telemetry on and off, interleaved (the order alternating
        # by round), each engine's prefix cache in the same state at
        # each round
        walls = {"off": [], "on": []}
        syncs = {"off": [], "on": []}
        for r in range(ONOFF_ROUNDS):
            if r == ONOFF_ROUNDS - 1:
                on.telemetry.clear()    # keep the last run's events
            order = (("off", off), ("on", on))
            for key, eng in (order if r % 2 == 0 else order[::-1]):
                with SyncCounter() as sc:
                    out = eng.generate(greedy, new)
                if out != ref:
                    raise AssertionError(f"{path} telemetry {key}: tokens "
                                         f"differ from the first run's")
                st = eng.last_stats
                walls[key].append(1e3 * st["wall_s"] / st["steps"])
                syncs[key].append(sc.n)
        if syncs["on"] != syncs["off"] or \
                on.compile_counts() != off.compile_counts() != counts:
            raise AssertionError(f"{path}: synchronizations {syncs} or "
                                 f"captures {on.compile_counts()} / "
                                 f"{off.compile_counts()} differ")
        med = {k: statistics.median(v) for k, v in walls.items()}
        overhead = med["on"] / med["off"] - 1.0
        ratios = [a / b - 1.0 for a, b in zip(walls["on"], walls["off"])]
        paired = statistics.median(ratios)
        events = list(on.telemetry.events)
        steps = on.last_stats["steps"]
        with tempfile.TemporaryDirectory() as tmp:
            trace = on.telemetry.export_chrome_trace(
                str(Path(tmp) / "trace.json"))
            with open(trace) as f:
                doc = json.load(f)
        by_name = collections.Counter(ev["name"] for ev in
                                      doc["traceEvents"])
        counters = prom_counters(on.telemetry.to_prometheus())
        # (4) the idle split: the last unprofiled run's spans, the device
        # time of the same steps run once more under the profiler (the
        # kernel's launches counted from 0 over that run)
        zero()
        _, busy = device_busy_s(lambda: on.generate(greedy, new))
        launches[f"robust_{path}"] = count(kernel)
        if on.last_stats["steps"] != steps:
            raise AssertionError(f"{path}: the profiled run took "
                                 f"{on.last_stats['steps']} steps, not "
                                 f"{steps}")
        split = idle_split(events, busy)
        res[f"onoff_{path}"] = {
            "step_ms_off": med["off"], "step_ms_on": med["on"],
            "rounds_off": walls["off"], "rounds_on": walls["on"],
            "overhead": overhead, "overhead_paired_median": paired,
            "overhead_paired_rounds": ratios,
            "syncs_per_run": syncs["on"], "captures": counts}
        res[f"idle_{path}"] = split
        log(f"robust (3) {path} [{card}]: telemetry on/off token-identical "
            f"over {ONOFF_ROUNDS} interleaved runs each, captures {counts} "
            f"both, host synchronizations a run {syncs['on']} both; step "
            f"wall ms off {spread(walls['off'])}, on "
            f"{spread(walls['on'])}: overhead {100 * overhead:+.2f}% of "
            f"the medians; paired: median {100 * paired:+.2f}% of the "
            f"{ONOFF_ROUNDS} rounds' ratios, spread "
            f"{100 * min(ratios):+.2f}% to {100 * max(ratios):+.2f}% "
            f"(the 3% contract is read, not enforced, here)")
        log(f"robust (3) {path}: trace events by name {dict(by_name)}")
        log(f"robust (3) {path}: Prometheus counters "
            f"{json.dumps(counters, sort_keys=True)}")
        log(f"robust (4) {path} [{card}]: {split['steps']} steps, step "
            f"wall {split['step_wall_ms']:.4f} ms = host gap between spans "
            f"{split['gap_ms']:.4f} ({split['gap_share']:.3f}) + span "
            f"{split['span_ms']:.4f}, of which device "
            f"{split['device_ms']:.4f} ({split['device_share']:.3f}) and "
            f"in-span excess {split['excess_ms']:.4f} "
            f"({split['excess_share']:.3f}); {kernel} launches "
            f"{launches[f'robust_{path}']}")
        on.close()
        del on
        # (1) chaos
        eng = ServeEngine(lm, dataclasses.replace(
            cfg, fault_spec=f"{site}:transient@{CHAOS_HITS}"), device="cuda")
        counts = eng.warmup()
        deadlines = [None] * len(greedy)
        deadlines[CHAOS_DEADLINE_RID] = 1e-9

        def on_step(step, eng=eng):
            if step == CHAOS_CANCEL_STEP:
                if not eng.cancel(CHAOS_CANCEL_RID):
                    raise AssertionError("chaos: the cancel found no "
                                         "request")
            eng.cache.check_invariants()

        out = eng.generate(greedy, new, deadline_s=deadlines,
                           on_step=on_step)
        st = eng.last_stats
        outcomes = [r["outcome"] for r in st["requests"]]
        for i, (o, r) in enumerate(zip(out, ref)):
            if i == CHAOS_DEADLINE_RID:
                ok = o == [] and outcomes[i] == "deadline_expired" and \
                    st["requests"][i]["ttft_s"] is None
            elif i == CHAOS_CANCEL_RID:
                ok = o == r[:len(o)] and len(o) < new and \
                    outcomes[i] == "cancelled"
            else:
                ok = o == r and outcomes[i] == "completed"
            if not ok:
                raise AssertionError(f"chaos {path}: request {i} "
                                     f"({outcomes[i]}) is wrong")
        if st["retries"] != 2 or eng.compile_counts() != counts:
            raise AssertionError(f"chaos {path}: retries {st['retries']}, "
                                 f"captures {eng.compile_counts()} vs "
                                 f"{counts}")
        eng.cache.check_invariants()
        res[f"chaos_{path}"] = {"retries": st["retries"],
                                "outcomes": outcomes,
                                "cancelled_tokens": len(
                                    out[CHAOS_CANCEL_RID]),
                                "steps": st["steps"]}
        log(f"robust (1) chaos {path}: {site}:transient@{CHAOS_HITS}, "
            f"cancel of request {CHAOS_CANCEL_RID} at step "
            f"{CHAOS_CANCEL_STEP} ({len(out[CHAOS_CANCEL_RID])} tokens, a "
            f"prefix of its fault-free stream), deadline 1e-9 on request "
            f"{CHAOS_DEADLINE_RID}: the other {len(greedy) - 2} streams "
            f"token-identical to the fault-free captured run, retries "
            f"{st['retries']}, captures {eng.compile_counts()} unchanged, "
            f"invariants clean after each of {st['steps']} steps")
        eng.close()
        del eng
        # (2) a fatal step, on the mixed path
        if path == "mixed":
            with tempfile.TemporaryDirectory() as tmp:
                eng = ServeEngine(lm, dataclasses.replace(
                    cfg, fault_spec=f"{site}:fatal@{FATAL_HIT}",
                    postmortem_dir=tmp), device="cuda")
                counts = eng.warmup()
                try:
                    eng.generate(greedy, new)
                    raise AssertionError("fatal: the planted fault did not "
                                         "fire")
                except faults.InjectedFault:
                    pass
                bundles = list(Path(tmp).glob("postmortem-*.json"))
                if len(bundles) != 1:
                    raise AssertionError(f"fatal: bundles {bundles}")
                with open(bundles[0]) as f:
                    bundle = json.load(f)
                missing = [k for k in POSTMORTEM_KEYS if k not in bundle]
                if bundle.get("schema") != POSTMORTEM_SCHEMA or missing \
                        or bundle["reason"] != "fault_abort":
                    raise AssertionError(f"fatal: bundle schema "
                                         f"{bundle.get('schema')}, reason "
                                         f"{bundle.get('reason')}, missing "
                                         f"{missing}")
                eng.cache.check_invariants()
                out = eng.generate(greedy, new)
                if out != ref or eng.compile_counts() != counts:
                    raise AssertionError("fatal: the next batch differs or "
                                         "captured anew")
            res["fatal"] = {"detail": bundle["detail"],
                            "events": len(bundle["events"]),
                            "fired": bundle["faults"]["fired"]}
            log(f"robust (2) fatal {site}:fatal@{FATAL_HIT}: "
                f"{bundle['detail']['failed_inflight']} in-flight requests "
                f"failed, bundle {bundles[0].name} ({POSTMORTEM_SCHEMA}, "
                f"{len(bundle['events'])} events, faults "
                f"{bundle['faults']['fired']}); the next batch "
                f"token-identical to the fault-free run, captures "
                f"{eng.compile_counts()} unchanged")
            eng.close()
            del eng
        off.close()
        del off
        gc.collect()
        torch.cuda.empty_cache()

    # (5) fit under the dispatch window, telemetry on and off
    m = fit_model()
    x, y = lm_arrays(LB * FIT_STEPS)
    trees = (m.state.params, *m.state.opt_state.values())
    # detached: a clone that autograd records would create each master's
    # gradient-accumulator node now, on the default stream, and the
    # captured step's backward would then launch on that stream
    start = [{op: {k: w.detach().clone() for k, w in p.items()}
              for op, p in t.items()} for t in trees]

    @torch.no_grad()
    def reset():
        for tree, snap in zip(trees, start):
            for op, p in tree.items():
                for k, w in p.items():
                    w.copy_(snap[op][k])
        m.state.step = m._host_step = 0
        if hasattr(m, "_fit_rng"):
            del m._fit_rng

    def run_fit(depth, telemetry):
        reset()
        m.config.train_dispatch_depth = depth
        m.config.telemetry = telemetry
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.fit(x, y, epochs=1, verbose=False, prefetch=True)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / FIT_STEPS

    fa.launches.update(dict.fromkeys(fa.launches, 0))
    run_fit(2, False)                       # captures the step
    masters = {}
    stats = {}
    step_ms = {d: [] for d in DEPTHS}
    with tempfile.TemporaryDirectory() as tmp:
        for telemetry in (False, True):
            for depth in DEPTHS:
                if telemetry and depth == 2:
                    with profiling.trace(tmp) as where:
                        run_fit(depth, telemetry)
                    tfile = Path(where) / profiling.TRACE_FILE
                    if not tfile.is_file() or tfile.stat().st_size == 0:
                        raise AssertionError(f"profiling.trace wrote no "
                                             f"{tfile}")
                    trace_bytes = tfile.stat().st_size
                else:
                    run_fit(depth, telemetry)
                masters[(depth, telemetry)] = weights_of(m)
                stats[(depth, telemetry)] = dict(m.last_train_stats)
                if telemetry != m.telemetry.enabled:
                    raise AssertionError("fit: telemetry not as asked")
        for _ in range(3):                  # timed rounds, interleaved
            for depth in DEPTHS:
                step_ms[depth].append(run_fit(depth, False))
    first = masters[(0, False)]
    for key, w in masters.items():
        wdiff, worst = max_weight_diff(first, w)
        if wdiff != 0.0:
            raise AssertionError(f"fit depth/telemetry {key}: masters "
                                 f"differ by {wdiff} at {worst}")
    if m.compile_counts() != {"train_step": 1}:
        raise AssertionError(f"fit: captures {m.compile_counts()}")
    fits = 1 + 2 * len(DEPTHS) + 3 * len(DEPTHS)
    flash = {k: fa.launches[k] for k in fa.FLASH_KERNELS}
    if flash != dict.fromkeys(flash, LM_ARCH["num_layers"] * FIT_STEPS
                              * fits):
        raise AssertionError(f"fit: flash launches {flash} over {fits} "
                             f"fits of {FIT_STEPS} steps")
    launches["robust_fit"] = flash
    for depth in DEPTHS:
        st = stats[(depth, True)]
        want = FIT_STEPS if depth == 0 else depth
        if st["dispatches"] != FIT_STEPS or st["max_in_flight"] != want:
            raise AssertionError(f"fit depth {depth}: {st}")
    res["fit"] = {
        "step_ms": {d: statistics.median(v) for d, v in step_ms.items()},
        "step_ms_rounds": step_ms,
        "last_train_stats": {d: stats[(d, True)] for d in DEPTHS},
        "trace_bytes": trace_bytes}
    for depth in DEPTHS:
        log(f"robust (5) fit depth {depth} [{card}]: step ms "
            f"{spread(step_ms[depth])}; last_train_stats "
            f"{json.dumps(stats[(depth, True)], sort_keys=True)}")
    log(f"robust (5) fit: masters bit-equal across depths {DEPTHS} x "
        f"telemetry off/on after {FIT_STEPS} steps each; captures "
        f"{m.compile_counts()}; profiling.trace wrote {trace_bytes} bytes")
    release(m)
    del m, start
    gc.collect()
    torch.cuda.empty_cache()
    log(f"robust phase {time.perf_counter() - t_phase:.1f} s")
    return res, launches


# ---------------------------------------------------- the training loop
# the LM at full width with GPT-2's resid_pdrop / attn_pdrop of 0.1 where
# the JAX package applies them (attention's output, a Dropout after each
# block's FFN), trained through fit under the bf16 policy
# ------------------------------------------- the serving tier
# LoRA: the pool's rank, and the 8 greedy prompts' tenants (0 the base
# model; 1 and 2 at rank 16; 3 at rank 8, zero-padded into the pool)
TIER_RANK = 16
TIER_TENANTS = (0, 1, 2, 3, 0, 1, 2, 3)
TIER_RANKS = {1: 16, 2: 16, 3: 8}
# the host tier: its budget, and a page pool too small for two working
# sets of TIER_SET prompts (each a 64-token prefix shared by two of
# them plus a 16-token tail; ~30 pages a set with the 32 new tokens),
# so a working set's parked prefix pages are evicted (spilled) by the
# next set and reloaded by its return; 36 pages is the least pool that
# holds one 512-token sequence (32 pages) with room to spare
TIER_HOST_MB = 8.0
TIER_HOST_PAGES = 36
TIER_SET = 6
# the router: two replicas, JAX's router bench stream at full width
TIER_TRAFFIC = dict(requests=64, tenants=4, prefix_tokens=48,
                    vocab=32000, max_prompt=96, seed=0)
TIER_RATE = 0.25          # arrivals per priced step (price_probe(64))
# profiler classes of the LoRA step (first match wins); the per-lane
# slab gather is index_select (indexSelect*Index kernels, or the
# vectorized gather of newer PyTorch)
LORA_CLASSES = (
    ("attention", re.compile(r"ragged_v2_\w*kernel")),
    ("slab_gather", re.compile(r"indexSelect|index_select|gather",
                               re.I)),
    ("matmul", re.compile(r"gemm|gemv|matmul|sm90_|cutlass|cublas", re.I)),
    ("topk", re.compile(r"topk|sort|radix|argmax|reduce_kernel.*max",
                        re.I)),
    ("kv_scatter", re.compile(r"index_put|indexing|scatter", re.I)),
    ("copy", re.compile(r"memcpy|memset|copy", re.I)),
)


def device_ms_by_class(fn, classes):
    """(result of fn(), {class: device ms}) under torch.profiler, CUDA
    activity only; every kernel lands in the first class whose pattern
    matches its name, else "other"."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ms = collections.defaultdict(float)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        cls = next((c for c, pat in classes if pat.search(e.key)),
                   "other")
        ms[cls] += float(e.self_device_time_total) / 1e3
    if not ms:
        raise RuntimeError("the profiler saw no device time")
    return out, dict(ms)


def tier_adapters():
    """{tenant: (weights, scale)} at the LM's shapes, from numpy seeds
    (make_tenant_adapters): tenants 1, 2 at rank 16, tenant 3 at rank
    8."""
    from flexflow_tpu_torch.serve.adapters import make_tenant_adapters
    shape = dict(num_layers=LM_ARCH["num_layers"],
                 hidden=LM_ARCH["hidden"], num_heads=LM_ARCH["num_heads"],
                 head_dim=LM_ARCH["hidden"] // LM_ARCH["num_heads"],
                 ff_dim=LM_ARCH["ff_dim"])
    return {t: make_tenant_adapters(rank=r, tenants=1, seed=100 + t,
                                    **shape)[1]
            for t, r in TIER_RANKS.items()}


def tier_host_sets(vocab, seed=1):
    """Two working sets of TIER_SET prompts: pairs sharing a 64-token
    prefix, each with its own 16-token tail."""
    rng = np.random.default_rng(seed)
    rand = lambda n: [int(x) for x in rng.integers(1, vocab, n)]  # noqa
    sets = []
    for _ in range(2):
        pres = [rand(64) for _ in range(TIER_SET // 2)]
        sets.append([pres[i // 2] + rand(16) for i in range(TIER_SET)])
    return sets


def tier_phase(pr, card: str, lm):
    """The serving tier at the trained LM's full width. (1) LoRA: the 8
    greedy prompts x 32 new tokens under tenants TIER_TENANTS through a
    rank-16 adapter pool (qkv, wo, ff1, ff2), on f32 and int8 pages:
    each adapted stream against ``generate_reference`` on its tenant's
    merged weights (``merge_adapter_params``) under the tie rule
    (PARITY_MARGIN on f32, the pool's kv_tie_margin on int8), the
    captured engine token for token an eager one's, no capture after
    warmup and the adapter loads; then the mixed f32 step with tenants
    against the unarmed engine's: step wall over 3 interleaved runs and
    device ms by class (the slab gather its own). (2) the host tier: two
    working sets alternating a, b, a over a TIER_HOST_PAGES-page pool
    with an 8 MB store, f32 and int8 pages: pages spill and reload
    (reload_pages > 0), the tokens those of the same runs with the tier
    off (tie rule), no new capture; and the pinned host-to-device copy
    rate of a page batch beside the priced ``host_transfer``. (3) the
    router: two replicas serve TIER_TRAFFIC at TIER_RATE / price, once
    per policy: every completed stream equal to a single engine's
    (exact, else within the tie rule), no capture after warmup, every
    page back; prefix-hit pages per policy. Kernel 1's launches of each
    main run are counted from 0 just before it."""
    t_phase = time.perf_counter()
    res, launches = {}, {}
    for part in (tier_lora, tier_host, tier_router):
        r, n = part(pr, card, lm)
        res.update(r)
        launches.update(n)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"tier phase {res['phase_s']:.1f} s")
    return res, launches


def tier_lora(pr, card: str, lm):
    """tier_phase (1): LoRA tokens, captured = eager, and the LoRA step
    against the base step."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.models.transformer import TransformerLM
    from flexflow_tpu_torch.serve import ServeEngine, merge_adapter_params
    greedy, _ = serve_prompts(LM_ARCH["vocab_size"])
    tenants = list(TIER_TENANTS)
    new = 32
    res, launches = {}, {}
    adapters = tier_adapters()

    # (1) LoRA: one merged-weight reference per tenant (pages play no
    # part in it), shared by both page types
    base = ServeEngine(lm, FFConfig(), device="cuda")
    refs = [None] * len(greedy)
    merged = {0: base.lm}
    for t, (w, sc) in adapters.items():
        merged[t] = TransformerLM(base.arch, merge_adapter_params(
            base.params, w, sc))
    for t in sorted(merged):
        idx = [i for i, x in enumerate(tenants) if x == t]
        base.lm = merged[t]
        for i, r in zip(idx, base.generate_reference(
                [greedy[i] for i in idx], new)):
            refs[i] = r
    base.lm = merged[0]
    for kv in ("float32", "int8"):
        cfg = FFConfig(kv_dtype=kv, adapter_rank=TIER_RANK)
        runs = {}
        for mode, capture in (("captured", True), ("eager", False)):
            eng = ServeEngine(lm, cfg, device="cuda", capture=capture)
            counts = eng.warmup()
            for t, (w, sc) in adapters.items():
                eng.register_adapter(t, w, scale=sc)
            pr.launches = 0
            out = eng.generate(greedy, new, tenant_ids=tenants)
            runs[mode] = (eng, out, pr.launches, counts)
        eng, out, n_launch, counts = runs["captured"]
        if runs["eager"][1] != out:
            raise AssertionError(f"lora {kv}: captured tokens differ from "
                                 f"the eager run's")
        st = eng.last_stats
        if eng.compile_counts() != counts or counts["adapter"] != 1:
            raise AssertionError(f"lora {kv}: captures {counts} -> "
                                 f"{eng.compile_counts()}")
        if n_launch != eng.num_layers * st["steps"] or not n_launch:
            raise AssertionError(f"lora {kv}: kernel 1 launches {n_launch}"
                                 f" != {eng.num_layers} x {st['steps']}")
        margin = PARITY_MARGIN if kv == "float32" else eng.kv_tie_margin
        exact = 0
        for t in sorted(merged):
            idx = [i for i, x in enumerate(tenants) if x == t]
            eng.lm = merged[t]
            exact += eng.assert_token_parity(
                [greedy[i] for i in idx], [out[i] for i in idx],
                [refs[i] for i in idx], margin=margin)
        eng.lm = merged[0]
        pool = st["adapter_pool"]
        launches[f"lora_{kv}"] = n_launch
        res[f"lora_{kv}"] = {"steps": st["steps"], "exact": exact,
                             "captures": counts, "adapter_pool": pool}
        log(f"tier (1) lora {kv} [{card}]: tenants {tenants} (rank "
            f"{TIER_RANKS}, pool rank {TIER_RANK}, {pool['usable_slots']} "
            f"slots of {pool['bytes_per_slot'] / 2**20:.2f} MiB): "
            f"{exact}/{len(greedy)} streams token-identical to their "
            f"tenant's merged-weight reference (rest diverge at a tie <= "
            f"{margin}); captured = eager token for token; loads "
            f"{pool['loads']}; captures {counts} unchanged; kernel 1 "
            f"launches {n_launch} = {eng.num_layers} x {st['steps']}")
        if kv == "float32":
            lora_eng = eng
        for e, *_ in runs.values():
            if e is not lora_eng:
                e.close()
        del runs
    # the LoRA step against the base step: the armed engine with
    # tenants, the unarmed one without; walls interleaved, then one
    # profiled run each
    base.warmup()
    walls = {"base": [], "lora": []}
    for r in range(3):
        for key in (("base", "lora") if r % 2 == 0 else ("lora", "base")):
            eng = base if key == "base" else lora_eng
            eng.generate(greedy, new, tenant_ids=None if key == "base"
                         else tenants)
            st = eng.last_stats
            walls[key].append(1e3 * st["wall_s"] / st["steps"])
    prof = {}
    for key, eng in (("base", base), ("lora", lora_eng)):
        _, ms = device_ms_by_class(lambda: eng.generate(
            greedy, new, tenant_ids=None if key == "base" else tenants),
            LORA_CLASSES)
        steps = eng.last_stats["steps"]
        prof[key] = {c: v / steps for c, v in sorted(ms.items())}
        prof[key]["total"] = sum(ms.values()) / steps
    res["lora_step"] = {"wall_ms": walls, "device_ms_per_step": prof}
    log(f"tier (1) lora step [{card}]: mixed f32, step wall ms base "
        f"{spread(walls['base'])}, with tenants {spread(walls['lora'])}; "
        f"device ms a step by class: base "
        f"{json.dumps({k: round(v, 4) for k, v in prof['base'].items()})}"
        f", lora {json.dumps({k: round(v, 4) for k, v in prof['lora'].items()})}")
    lora_eng.close()
    base.close()
    del lora_eng, base, merged
    gc.collect()
    torch.cuda.empty_cache()

    return res, launches


def tier_host(pr, card: str, lm):
    """tier_phase (2): spill and reload on f32 and int8 pages, and the
    host link's copy rate."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.search.machine_model import \
        default_machine_model
    from flexflow_tpu_torch.serve import ServeEngine
    new = 32
    res, launches = {}, {}
    sets = tier_host_sets(LM_ARCH["vocab_size"])
    for kv in ("float32", "int8"):
        outs = {}
        for tier in (True, False):
            eng = ServeEngine(lm, FFConfig(
                kv_dtype=kv, kv_num_pages=1 + TIER_HOST_PAGES,
                host_tier_mb=TIER_HOST_MB, serve_host_tier=tier),
                device="cuda")
            counts = eng.warmup()
            pr.launches = 0
            outs[tier] = [eng.generate(p, new) for p in
                          (sets[0], sets[1], sets[0])]
            if tier:
                n_launch = pr.launches
                host = eng.last_stats["host_tier"]
                if eng.compile_counts() != counts or \
                        counts["export"] != 1 or counts["import"] != 1:
                    raise AssertionError(f"host {kv}: captures {counts} "
                                         f"-> {eng.compile_counts()}")
                on_eng, on_counts = eng, counts
            else:
                off_eng = eng
        if host["reload_pages"] <= 0 or host["spilled_pages"] <= 0 \
                or not n_launch:
            raise AssertionError(f"host {kv}: no spill/reload {host}, "
                                 f"kernel 1 launches {n_launch}")
        margin = PARITY_MARGIN if kv == "float32" else \
            off_eng.kv_tie_margin
        exact = sum(off_eng.assert_token_parity(p, a, b, margin=margin)
                    for p, a, b in zip((sets[0], sets[1], sets[0]),
                                       outs[True], outs[False]))
        decisions = collections.Counter(
            (r.host_reload or {}).get("chose") for r in
            on_eng._last_reqs.values())
        launches[f"host_{kv}"] = n_launch
        res[f"host_{kv}"] = {"host_tier": host, "exact": exact,
                             "decisions": dict(decisions)}
        log(f"tier (2) host {kv} [{card}]: rounds a, b, a over "
            f"{TIER_HOST_PAGES} pages and an {TIER_HOST_MB:g} MB store: "
            f"spilled {host['spilled_pages']} pages, reloaded "
            f"{host['reload_pages']} in {host['reload_events']} events "
            f"(priced {1e3 * host['reload_priced_s']:.4f} ms), recompute "
            f"chosen {host['recompute_chosen']}, last round's decisions "
            f"{dict(decisions)}; {exact}/{3 * TIER_SET} streams "
            f"token-identical to the tier-off run (rest at a tie <= "
            f"{margin}); captures {on_counts} unchanged; kernel 1 "
            f"launches {n_launch}")
        c = on_eng.cache_cfg
        on_eng.close()
        off_eng.close()
        del on_eng, off_eng
    # the host link: pinned host -> device copies of one page batch
    # (pages_per_seq f32 pages of k and v), against the priced copy
    nbytes = 2 * c.num_layers * c.pages_per_seq * c.page_size \
        * c.num_heads * c.head_dim * 4
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    copies = [cuda_ms(lambda: dst.copy_(src, non_blocking=True), 10)
              for _ in range(3)]
    priced = 1e3 * default_machine_model().host_transfer(nbytes)
    rate = nbytes / (statistics.median(copies) / 1e3) / 1e9
    res["host_link"] = {"bytes": nbytes, "copy_ms": copies,
                        "gb_per_s": rate, "priced_ms": priced}
    log(f"tier (2) host link [{card}]: a page batch ({c.pages_per_seq} "
        f"f32 pages, {nbytes / 2**20:.2f} MiB) pinned host -> device ms "
        f"{spread(copies)} = {rate:.2f} GB/s; priced host_transfer "
        f"{priced:.4f} ms ({nbytes / priced / 1e6:.2f} GB/s, the "
        f"uncalibrated spec-sheet rate)")
    del src, dst

    return res, launches


def tier_router(pr, card: str, lm):
    """tier_phase (3): two replicas behind each policy."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import (ReplicaPool, ServeEngine,
                                          TrafficSpec, make_traffic)
    res, launches = {}, {}
    ref_eng = ServeEngine(lm, FFConfig(), device="cuda")
    ref_eng.warmup()
    for policy in ("affinity", "round_robin"):
        pool = ReplicaPool(lm, 2, policy=policy, config=FFConfig())
        price = pool.price_probe(64)
        traffic = make_traffic(TrafficSpec(rate_rps=TIER_RATE / price,
                                           **TIER_TRAFFIC))
        pr.launches = 0
        rres = pool.run(traffic)
        n_launch = pr.launches
        pool.assert_zero_recompiles()
        pool.check_drained()
        want = ref_eng.generate([t.prompt for t in traffic],
                                [t.max_new for t in traffic],
                                stream_ids=[t.stream_id for t in traffic])
        done = [(t.prompt, rec["tokens"], w) for t, rec, w in
                zip(traffic, rres["requests"], want)
                if rec["outcome"] == "completed"]
        exact = sum(o == w for _, o, w in done)
        if exact < len(done):
            ref_eng.assert_token_parity([p for p, _, _ in done],
                                        [o for _, o, _ in done],
                                        [w for _, _, w in done],
                                        margin=PARITY_MARGIN)
        hits = {f"replica{r.idx}": r.session.stats_dict()[
            "prefix_hit_tokens"] // r.engine.cache_cfg.page_size
            for r in pool.replicas}
        if not n_launch or len(done) != len(traffic):
            raise AssertionError(f"router {policy}: kernel 1 launches "
                                 f"{n_launch}, {len(done)} of "
                                 f"{len(traffic)} completed")
        launches[f"router_{policy}"] = n_launch
        res[f"router_{policy}"] = {
            k: rres[k] for k in ("goodput_per_s", "makespan_s",
                                 "completed", "tokens_total", "routing",
                                 "per_replica")}
        res[f"router_{policy}"]["prefix_hit_pages"] = hits
        log(f"tier (3) router {policy} [{card}]: {len(traffic)} requests "
            f"over 2 replicas at {TIER_RATE} / {1e3 * price:.4f} ms; "
            f"{exact}/{len(done)} completed streams equal the single "
            f"engine's exactly (rest within the tie rule <= "
            f"{PARITY_MARGIN}); prefix-hit pages {hits} (total "
            f"{sum(hits.values())}); routing {rres['routing']}; virtual "
            f"makespan {1e3 * rres['makespan_s']:.3f} ms; no capture after "
            f"warmup, every page back; kernel 1 launches {n_launch}")
        pool.close()
        del pool
    ref_eng.close()
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


# ------------------------------------------- disaggregated serving
# the wall-clock router: SLOs in measured mixed-step walls of this run
# (the f32 step of disagg (a)); arrivals paced so that TIER_RATE of
# them land per measured step
WALL_SLO_TTFT_STEPS = 40.0
WALL_SLO_TPOT_STEPS = 4.0
LEDGER_REL = 0.05          # memory_ledger's accounting vs live tensors


def disagg_phase(pr, card: str, lm):
    """Disaggregated serving, the wall-clock router and the serve cost
    stack at the trained LM's full width. (a) ``measure.calibrate`` on
    the card; the mixed f32 step (the trained LM) and a bf16 one (the
    same architecture under compute_dtype bfloat16) predicted by
    ``simulate_serve_step`` with the model's default factors and this
    run's calibration, against the measured step wall and device ms. (b)
    ``memory_ledger`` of the f32 engine after a generate: ledger_vs_live
    within LEDGER_REL, total_bytes beside max_memory_allocated. (c) a
    1:1 DisaggCluster on f32 and int8 pages, in process and over TCP:
    the 8 greedy prompts x 32 new tokens against the unified engine's
    (exact, else the tie rule: PARITY_MARGIN on f32, the pool's margin
    on int8), the handoff's pages, bytes and measured seconds against
    host_transfer's price, the decode role's step against the unified
    one's, kernel 1's launches per role (layers x steps) and no capture
    after warmup. (d) two replicas on the wall clock, threaded and
    round-robin, over tier_router's stream: every stream's tokens those
    of the virtual run (else the tie rule), explain_request summing to
    the measured latency, both goodputs and their ratio. (e)
    ``optimize_serve_disagg``'s ratio table for this LM at 2 devices.
    Kernel 1's launches of each main run are counted from 0 just before
    it."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.search import measure
    from flexflow_tpu_torch.search.machine_model import \
        default_machine_model
    from flexflow_tpu_torch.search.serve_place import optimize_serve_disagg
    from flexflow_tpu_torch.search.simulator import simulate_serve_step
    from flexflow_tpu_torch.serve import (DisaggCluster, ReplicaPool,
                                          ServeEngine, TrafficSpec,
                                          make_traffic, probe_serve_arch)
    from flexflow_tpu_torch.utils.telemetry import Telemetry, pow2_bucket
    t_phase = time.perf_counter()
    res, launches = {}, {}
    greedy, _ = serve_prompts(LM_ARCH["vocab_size"])
    new = 32
    ctx_b = pow2_bucket(int(sum(len(p) + new // 2 for p in greedy)
                            / len(greedy)))

    # (a) calibration, and the predicted mixed step against the measured
    mm = default_machine_model()
    default = default_machine_model()
    cal = measure.calibrate(mm)
    res["calibration"] = cal
    log(f"disagg (a) calibration [{card}]: "
        f"{json.dumps({k: round(v, 6) for k, v in cal.items()})} "
        f"(fractions of the datasheet peaks; step_overhead_s seconds)")
    lm16 = lm_model("bfloat16")
    steps = {}
    f32_eng = None
    for name, model in (("f32", lm), ("bf16", lm16)):
        eng = ServeEngine(model, FFConfig(), device="cuda")
        eng.warmup()
        torch.cuda.reset_peak_memory_stats()
        out, busy = device_busy_s(lambda: eng.generate(greedy, new))
        st = eng.last_stats
        arch = eng.serve_arch(context=ctx_b)
        pred = {k: 1e3 * simulate_serve_step(arch, 1, m,
                                             lanes=eng.mixed_width)
                for k, m in (("default", default),
                             ("calibrated", mm))}
        steps[name] = {
            "steps": st["steps"], "context_bucket": ctx_b,
            "lanes": eng.mixed_width,
            "wall_ms": 1e3 * st["wall_s"] / st["steps"],
            "device_ms": 1e3 * busy / st["steps"],
            "predicted_ms": pred}
        log(f"disagg (a) mixed {name} step [{card}]: {eng.mixed_width} "
            f"lanes at context bucket {ctx_b}: predicted "
            f"{pred['default']:.4f} ms (the model's defaults) / "
            f"{pred['calibrated']:.4f} ms (this run's calibration); "
            f"measured wall "
            f"{steps[name]['wall_ms']:.4f} ms, device "
            f"{steps[name]['device_ms']:.4f} ms a step over "
            f"{st['steps']} steps")
        if name == "f32":
            f32_eng, f32_out = eng, out
        else:
            eng.close()
    res["mixed_step"] = steps
    del lm16
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the memory ledger after a generate
    led = f32_eng.memory_ledger()
    peak = torch.cuda.max_memory_allocated()
    ratio = led["ledger_vs_live"]
    if ratio is None or abs(ratio - 1.0) > LEDGER_REL:
        raise AssertionError(f"memory_ledger: ledger_vs_live {ratio} "
                             f"outside {LEDGER_REL}")
    res["ledger"] = {k: led[k] for k in (
        "params_bytes", "kv_pool_bytes", "activation_est_bytes",
        "total_bytes", "live_bytes", "ledger_vs_live",
        "sim_hbm_input_bytes")}
    res["ledger"]["max_memory_allocated"] = peak
    log(f"disagg (b) memory ledger [{card}]: params "
        f"{led['params_bytes'] / 2**20:.2f} MiB, KV pool "
        f"{led['kv_pool_bytes'] / 2**20:.2f} MiB, activation estimate "
        f"{led['activation_est_bytes'] / 2**20:.2f} MiB, total "
        f"{led['total_bytes'] / 2**20:.2f} MiB; live tensors "
        f"{led['live_bytes'] / 2**20:.2f} MiB (ledger_vs_live "
        f"{ratio:.4f}); max_memory_allocated over the generate "
        f"{peak / 2**20:.2f} MiB (the trained model's optimizer state "
        f"and the step's temporaries included)")
    uni_dec_ms = 1e3 * float(np.mean(
        f32_eng.last_stats["decode_step_times_s"] or [0.0]))
    f32_eng.close()

    # (c) the 1:1 cluster, in process and over TCP, f32 and int8 pages
    clusters = {}
    for kv in ("float32", "int8"):
        uni = ServeEngine(lm, FFConfig(kv_dtype=kv), device="cuda")
        uni.warmup()
        ref = uni.generate(greedy, new)
        uni_st = uni.last_stats
        for transport in ("", "tcp"):
            cfg = FFConfig(kv_dtype=kv, serve_transport=transport)
            with DisaggCluster(lm, config=cfg, device="cuda") as cl:
                counts = cl.warmup()
                pr.launches = 0
                out = cl.generate(greedy, new)
                n_launch = pr.launches
                st = cl.last_stats
                if cl.compile_counts() != counts:
                    raise AssertionError(
                        f"disagg {kv} {transport or 'inproc'}: captures "
                        f"{counts} -> {cl.compile_counts()}")
                role_steps = {
                    role: sum(x["steps"] for x in st["roles"][role])
                    for role in ("prefill", "decode")}
                want = cl.prefill[0].num_layers * sum(
                    role_steps.values())
                if n_launch != want or not n_launch:
                    raise AssertionError(
                        f"disagg {kv}: kernel 1 launches {n_launch} != "
                        f"{want} (layers x role steps {role_steps})")
                exact = sum(o == r for o, r in zip(out, ref))
                margin = PARITY_MARGIN if kv == "float32" else \
                    uni.kv_tie_margin
                if exact < len(ref):
                    uni.assert_token_parity(greedy, out, ref,
                                            margin=margin)
                hand = st["handoff"]
                priced = mm.host_transfer(hand["handoff_bytes"])
                dec = st["roles"]["decode"][0]
                dec_ms = 1e3 * float(np.mean(
                    dec["decode_step_times_s"] or [0.0]))
                uni_ms = 1e3 * float(np.mean(
                    uni_st["decode_step_times_s"] or [0.0]))
                key = f"{kv}_{transport or 'inproc'}"
                launches[f"disagg_{key}"] = n_launch
                clusters[key] = {
                    "exact": exact, "handoff": hand,
                    "handoff_priced_s": priced,
                    "decode_step_ms": dec_ms,
                    "unified_decode_step_ms": uni_ms,
                    "role_steps": role_steps,
                    "decode_budget": cl.decode_budget,
                    "wall_s": st["wall_s"],
                    "unified_wall_s": uni_st["wall_s"],
                    "captures": counts}
                if transport:
                    clusters[key]["frames"] = dict(cl._receiver.stats)
                log(f"disagg (c) {key} [{card}]: {exact}/{len(ref)} "
                    f"streams equal the unified engine's exactly (rest "
                    f"within the tie rule <= {margin}); handoff "
                    f"{hand['handoff_requests']} requests, "
                    f"{hand['handoff_pages']} pages, "
                    f"{hand['handoff_bytes'] / 2**20:.3f} MiB in "
                    f"{1e3 * hand['handoff_seconds']:.3f} ms measured "
                    f"(import side; "
                    f"{hand['handoff_bytes'] / max(hand['handoff_seconds'], 1e-12) / 1e9:.2f}"
                    f" GB/s) vs {1e3 * priced:.4f} ms priced by "
                    f"host_transfer; decode-role step "
                    f"{dec_ms:.4f} ms ({cl.decode_budget}-lane stub) vs "
                    f"unified {uni_ms:.4f} ms; kernel 1 launches "
                    f"{n_launch} = {cl.prefill[0].num_layers} layers x "
                    f"{role_steps}; captures {counts} unchanged")
        uni.close()
    res["cluster"] = clusters

    # (d) the router on the wall clock, threaded and round-robin
    step_s = steps["f32"]["wall_ms"] / 1e3
    ref_eng = ServeEngine(lm, FFConfig(), device="cuda")
    ref_eng.warmup()
    probe = ReplicaPool(lm, 2, config=FFConfig())
    price = probe.price_probe(64)
    traffic = make_traffic(TrafficSpec(rate_rps=TIER_RATE / price,
                                       **TIER_TRAFFIC))
    virt = probe.run(traffic)
    probe.close()
    slo = dict(slo_ttft_s=WALL_SLO_TTFT_STEPS * step_s,
               slo_tpot_s=WALL_SLO_TPOT_STEPS * step_s)
    wall = {}
    for threaded in (True, False):
        tel = Telemetry()
        pool = ReplicaPool(lm, 2, config=FFConfig(), telemetry=tel)
        pr.launches = 0
        wres = pool.run(traffic, wall_clock=True, wall_threads=threaded,
                        time_scale=step_s / price, dwell_s=0.0, **slo)
        n_launch = pr.launches
        pool.assert_zero_recompiles()
        pool.check_drained()
        vt = {r["stream_id"]: r["tokens"] for r in virt["requests"]}
        pairs = [(t.prompt, rec["tokens"], vt[rec["stream_id"]])
                 for t, rec in zip(traffic, wres["requests"])]
        exact = sum(a == b for _, a, b in pairs)
        if exact < len(pairs):
            ref_eng.assert_token_parity([p for p, _, _ in pairs],
                                        [a for _, a, _ in pairs],
                                        [b for _, _, b in pairs],
                                        margin=PARITY_MARGIN)
        worst = 0.0
        for rec in wres["requests"]:
            b = pool.explain_request(rec["stream_id"])
            worst = max(worst, abs(sum(b["components"].values())
                                   - b["latency_s"])
                        / max(b["latency_s"], 1e-12))
        if worst > 0.01:
            raise AssertionError(f"wall explain_request off by "
                                 f"{worst:.4f} of the latency")
        steps_by = sum(r["steps"] for r in wres["per_replica"])
        if n_launch != ref_eng.num_layers * steps_by or not n_launch:
            raise AssertionError(f"wall router: kernel 1 launches "
                                 f"{n_launch} != layers x {steps_by}")
        key = "threaded" if threaded else "round_robin"
        launches[f"wall_{key}"] = n_launch
        wall[key] = {k: wres[k] for k in (
            "goodput_per_s", "makespan_s", "slo_attainment", "completed",
            "tokens_total")}
        wall[key].update(exact=exact, explain_worst_rel=worst,
                         busy_wall_s=[r["busy_wall_s"]
                                      for r in wres["per_replica"]])
        log(f"disagg (d) wall router {key} [{card}]: {len(traffic)} "
            f"requests over 2 replicas, arrivals at {TIER_RATE} per "
            f"measured step ({1e3 * step_s:.3f} ms), SLO ttft "
            f"{1e3 * slo['slo_ttft_s']:.2f} ms tpot "
            f"{1e3 * slo['slo_tpot_s']:.2f} ms: goodput "
            f"{wres['goodput_per_s']:.2f} req/s, attainment "
            f"{wres['slo_attainment']:.3f}, makespan "
            f"{wres['makespan_s']:.3f} s; {exact}/{len(pairs)} streams "
            f"equal the virtual run's; explain_request within "
            f"{worst:.2e} of the latency; kernel 1 launches {n_launch}")
        pool.close()
    wall["goodput_ratio"] = wall["threaded"]["goodput_per_s"] / max(
        wall["round_robin"]["goodput_per_s"], 1e-12)
    res["wall_router"] = wall
    log(f"disagg (d) threaded / round-robin goodput [{card}]: "
        f"{wall['goodput_ratio']:.3f}")
    ref_eng.close()

    # (e) the ratio search for this LM at 2 devices
    arch = dataclasses.replace(probe_serve_arch(lm, FFConfig()),
                               handoff_stub_lanes=32)
    place = optimize_serve_disagg(arch, 2, mm=mm,
                                  config=FFConfig(search_cost_cache=False))
    res["ratio_search"] = {
        "ratio": place.ratio, "ratio_table": place.ratio_table,
        "decode_step_s": place.decode_step_s,
        "prefill_step_s": place.prefill_step_s,
        "transfer_s": place.transfer_s,
        "unified_tpot_s": place.unified_tpot_s,
        "tpot_reduction": place.tpot_reduction_vs_unified()}
    log(f"disagg (e) ratio search at 2 devices [{card}, calibrated]: "
        f"{place.ratio} (table {place.ratio_table}); decode step "
        f"{1e3 * place.decode_step_s:.4f} ms vs unified TPOT "
        f"{1e3 * place.unified_tpot_s:.4f} ms "
        f"({place.tpot_reduction_vs_unified():.3f}x), transfer "
        f"{1e3 * place.transfer_s:.4f} ms a request")
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"disagg phase {res['phase_s']:.1f} s")
    return res, launches


LM_DROPOUT = 0.1
FIT_STEPS = 8
DROPOUT_SHAPES = ((LB, TS, 512), (3, 1001, 77))


def dropout_lm_graph(batch, vocab_size, max_seq_len, hidden, num_heads,
                     num_layers, ff_dim, compute_dtype="bfloat16",
                     remat=False, seed=0, device="cuda", p=LM_DROPOUT,
                     mesh=None, strategy=None):
    """build_transformer_lm's graph, op for op with its op names, plus
    dropout ``p`` on each attention op and a Dropout(p) after each
    block's FFN, built with the port's FFModel calls
    (``build_transformer_lm`` takes no dropout argument, as the JAX
    function does not); on an executing ``mesh`` under ``strategy``
    when given."""
    from flexflow_tpu_torch import FFConfig, FFModel
    cfg = FFConfig(batch_size=batch, seed=seed, compute_dtype=compute_dtype,
                   remat=remat)
    ff = FFModel(cfg, device=device, mesh=mesh, strategy=strategy)
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
# numpy seeds, each measure at its largest over the three; its update
# taken from the moved weights). A deep
# ReLU net's gradient is not continuous: one activation that crosses 0
# under a rounding change moves the whole update below it, and in
# ResNet-50 and Inception a one-ulp change of the weights moves the
# first update by about 2% (JAX alone shows the same at the CPU tests'
# size, tests/test_torch_conv_models.py). In the BatchNorm nets each
# measure is held within SPREAD_FACTOR times that witness, or the fixed
# limit below where that is larger; the other models meet the fixed
# limits (their witness is logged). The loss is a forward quantity and
# has a fixed limit. Beside each difference the smoke counts the ReLU
# outputs whose mask differs (relu_masks): a difference past the fixed
# limits with no mask flipped is reported as a fault
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


def update_err(w0, wa, wb, w0a=None):
    """||du_a - du_b|| / ||du_b|| over all weights concatenated, du the
    change from w0 (each on the CPU, f32); run a's change is taken from
    ``w0a`` when its step started elsewhere (a one-ulp witness)."""
    w0a = w0 if w0a is None else w0a
    num = den = 0.0
    for n, w in w0.items():
        da = wa[n].float().cpu() - w0a[n]
        db = wb[n].float().cpu() - w
        num += float((da - db).square().sum())
        den += float(db.square().sum())
    return math.sqrt(num / den)


def worst_updates(w0, wa, wb, n=3, w0a=None):
    """The n weights whose updates differ most: [(name, ||du_a - du_b|| /
    max(||du_b||, UPDATE_FLOOR x the largest ||du_b|| of the model),
    ||du_b||)]. The floor holds a weight whose update is tiny to an
    absolute error instead (a conv bias before a BatchNorm: its true
    update is zero, what is left is rounding)."""
    w0a = w0 if w0a is None else w0a
    rows = []
    for k, w in w0.items():
        da = wa[k].float().cpu() - w0a[k]
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


def compare_steps(w0, s0, a, b, w0a=None):
    """The measures of step a = (loss, weights, states) against step b,
    both updates taken from w0 (run a's from ``w0a`` when given)."""
    return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
            "update_rel": update_err(w0, a[1], b[1], w0a),
            "worst_weights": worst_updates(w0, a[1], b[1], w0a=w0a),
            "states_rel": states_err(s0, a[2], b[2])}


def relu_sites(m):
    """The ops of m whose output is a ReLU's: batch norms with relu,
    relu units, and convs and denses with a relu activation."""
    return [op for op in m.ops
            if (op.op_type == "batch_norm" and op.relu)
            or (op.op_type == "element_unary" and op.mode == "relu")
            or getattr(op, "activation", None) == "relu"]


@contextlib.contextmanager
def relu_masks(m, into):
    """Record into ``into``, per ReLU site of m, the mask (output > 0)
    of the first forward the site runs, on the host (an eager step:
    a replayed graph runs no Python)."""
    sites = relu_sites(m)
    for op in sites:
        def wrapped(params, xs, ctx, op=op, f=op.forward):
            ys = f(params, xs, ctx)
            if op.name not in into:
                into[op.name] = (ys[0].detach() > 0).cpu()
            return ys
        op.forward = wrapped
    try:
        yield
    finally:
        for op in sites:
            del op.forward      # back to the class's method


def mask_flips(a, b):
    """The ReLU outputs whose mask differs between two runs' records:
    {"flips", "sites" (sites with a flip), "outputs" (all recorded)}."""
    per = {k: int((a[k] != b[k]).sum()) for k in a if k in b}
    return {"flips": sum(per.values()),
            "sites": sum(1 for v in per.values() if v),
            "outputs": sum(int(a[k].numel()) for k in per)}


def masked_step(m, batch):
    """one_step with the ReLU masks of its forward: (step, masks)."""
    masks = {}
    with relu_masks(m, masks):
        st = one_step(m, batch)
    return st, masks


def unexplained(what, measures, flips, loss_limit, update_limit):
    """A difference past the fixed f32 limits with no ReLU mask flipped
    is not explained by the masks: a fault, reported."""
    if flips["flips"] == 0 and (measures["loss_rel"] > loss_limit
                                or measures["update_rel"] > update_limit):
        log(f"FAULT: {what}: a difference with no ReLU mask flipped: "
            f"loss rel {measures['loss_rel']:.3g}, update rel "
            f"{measures['update_rel']:.3g}")
        return [what]
    return []


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
    stc, mcpu = masked_step(cpu, batch)
    cpu_s = time.perf_counter() - t0
    del cpu
    runs = []
    for seed in range(WITNESS_SEEDS):
        ulp = sweep_model(name, PARITY_BATCH, torch.float32, device="cpu")
        move_one_ulp(ulp, seed)
        # the witness's update is taken from its own (moved) weights: an
        # update below a weight's f32 spacing (most of the seq2seq's)
        # would otherwise count the one-ulp move itself as a difference
        wu = {n: w.float().clone() for n, w in weights_of(ulp).items()}
        stu, mulp = masked_step(ulp, batch)
        runs.append({**compare_steps(w0, s0, stu, stc, w0a=wu),
                     "mask_flips": mask_flips(mulp, mcpu)})
        del ulp
    # each measure at its largest over the seeds (running statistics:
    # None in a model without them)
    witness = {
        "loss_rel": max(r["loss_rel"] for r in runs),
        "update_rel": max(r["update_rel"] for r in runs),
        "worst_weights": max((r["worst_weights"] for r in runs),
                             key=lambda e: e[0][1]),
        "states_rel": max((r["states_rel"] or 0.0 for r in runs),
                          default=0.0) if s0 else None,
        "mask_flips": [r["mask_flips"] for r in runs],
        "seed_update_rel": [r["update_rel"] for r in runs],
        "unexplained": sum((unexplained(
            f"{name} one-ulp witness seed {k}", r, r["mask_flips"],
            CPU_LOSS_REL, UPDATE_REL) for k, r in enumerate(runs)), [])}
    card = sweep_model(name, PARITY_BATCH, torch.float32, capture=False)
    same = max_weight_diff({n: w.cuda() for n, w in w0.items()},
                           weights_of(card))
    if same[0] != 0.0:
        raise AssertionError(f"{name}: card and CPU initial weights differ "
                             f"{same}")
    groups = len(card.executor._conv_merge_leader)
    stg, mcard = masked_step(card, batch)
    del card
    res = {"cpu_step_s": cpu_s, "loss_card": stg[0], "loss_cpu": stc[0],
           **compare_steps(w0, s0, stg, stc), "ulp_witness": witness,
           "sibling_groups": groups, "mask_flips": mask_flips(mcard, mcpu)}
    res["unexplained"] = unexplained(f"{name} card vs CPU", res,
                                     res["mask_flips"], CPU_LOSS_REL,
                                     UPDATE_REL)
    knobs = {}
    if name not in ("candle_uno", "seq2seq"):
        knobs["nhwc"] = {"conv_layout": "NHWC"}
    if groups:
        knobs["no_sibling_fusion"] = {"sibling_conv_fusion": False}
    for kname, cfg in knobs.items():
        m = sweep_model(name, PARITY_BATCH, torch.float32, capture=False,
                        **cfg)
        stk, mk = masked_step(m, batch)
        res[kname] = {**compare_steps(w0, s0, stk, stg),
                      "mask_flips": mask_flips(mk, mcard)}
        res["unexplained"] += unexplained(
            f"{name} {kname} vs card", res[kname],
            res[kname]["mask_flips"], KNOB_LOSS_REL, UPDATE_REL)
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
        fl = p["mask_flips"]
        log(f"sweep {name}: ReLU masks flipped, card vs CPU: {fl['flips']} "
            f"of {fl['outputs']} outputs at {fl['sites']} sites (update "
            f"rel {p['update_rel']:.3g}); one-ulp witness seeds: "
            + ", ".join(f"{r['flips']} at {r['sites']} sites (update rel "
                        f"{u:.3g})"
                        for r, u in zip(w["mask_flips"],
                                        w["seed_update_rel"]))
            + "".join(f"; {k} vs card: {p[k]['mask_flips']['flips']} at "
                      f"{p[k]['mask_flips']['sites']} sites (update rel "
                      f"{p[k]['update_rel']:.3g})"
                      for k in ("nhwc", "no_sibling_fusion") if k in p)
            + f"; unexplained {p['unexplained'] + w['unexplained']}")
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


@contextlib.contextmanager
def zero_init():
    """Models built inside skip the numpy streams (every weight starts
    at zero), for a model whose weights are then copied from another on
    the card: DLRM "full" draws 1.7 G numbers a build."""
    from flexflow_tpu_torch.core.executor import Executor
    old = Executor._init_array
    Executor._init_array = lambda self, op, wname, spec: np.zeros(
        spec.shape, np.float32)
    try:
        yield
    finally:
        Executor._init_array = old


def copy_weights(dst, src):
    """Copy a {op: {name: tensor}} tree into model ``dst``'s parameters
    in place, on the card."""
    with torch.no_grad():
        for op, p in dst.state.params.items():
            for k, w in p.items():
                w.copy_(src[op][k])


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
    t0 = time.perf_counter()
    eager = dlrm_model(stacked=stacked, capture=False, **f)
    init_s = time.perf_counter() - t0
    # the captured model starts from the eager one's initial weights,
    # copied on the card (one build from the numpy streams, not two)
    w0 = {op: {k: w.detach().clone() for k, w in p.items()}
          for op, p in eager.state.params.items()}
    dev = [eager.executor.shard_batch(b) for b in host]
    le = [float(eager.train_batch(b)["loss"]) for b in dev]
    we = host_weights(eager)       # on the host: out of the peak below
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    sr.launches.update(dict.fromkeys(sr.launches, 0))
    t0 = time.perf_counter()
    with zero_init():
        m = dlrm_model(stacked=stacked, **f)
    copy_weights(m, w0)
    del w0
    gc.collect()
    torch.cuda.empty_cache()
    copy_s = time.perf_counter() - t0
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
           "second_build_s": copy_s,
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
        f"({res['table_gb']:.2f} GB), batch {b}; build {init_s:.1f} s from "
        f"the numpy streams, the captured model's {copy_s:.1f} s from the "
        f"eager one's initial weights on the card; 3 captured steps = 3 "
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
    stc, mcpu = masked_step(cpu, batch)
    cpu_s = time.perf_counter() - t0
    del cpu
    card = dlrm_model(capture=False, **s)
    same = max_weight_diff({n: w.cuda() for n, w in w0.items()},
                           weights_of(card))
    if same[0] != 0.0:
        raise AssertionError(f"dlrm: card and CPU initial weights differ "
                             f"{same}")
    stg, mcard = masked_step(card, batch)
    del card
    torch.cuda.empty_cache()
    res = {"cpu_step_s": cpu_s, "loss_card": stg[0], "loss_cpu": stc[0],
           **compare_steps(w0, {}, stg, stc),
           "mask_flips": mask_flips(mcard, mcpu),
           "limits": {"loss_rel": DLRM_CPU_LOSS_REL,
                      "update_rel": DLRM_UPDATE_REL,
                      "each": DLRM_UPDATE_REL}}
    res["unexplained"] = unexplained("dlrm card vs CPU", res,
                                     res["mask_flips"], CPU_LOSS_REL,
                                     UPDATE_REL)
    log(f"dlrm card f32 step vs CPU ({s['tables']} x {s['vocab']}, batch "
        f"{s['batch']}): loss {stg[0]} vs {stc[0]} (rel "
        f"{res['loss_rel']:.3g}, limit {DLRM_CPU_LOSS_REL}), update rel "
        f"{res['update_rel']:.3g}, worst weight "
        f"{res['worst_weights'][0][0]} {res['worst_weights'][0][1]:.3g} "
        f"(limits {DLRM_UPDATE_REL}); ReLU masks flipped "
        f"{res['mask_flips']['flips']} of {res['mask_flips']['outputs']} "
        f"outputs at {res['mask_flips']['sites']} sites, unexplained "
        f"{res['unexplained']}; CPU step {cpu_s:.2f} s")
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


# the search phase (search_phase): calibration runs `SEARCH_CAL_STEPS`
# timed steps after one warm step (the capture) per model; grounding
# measures the top `SEARCH_TOP_OPS` op signatures; the searches anneal
# `SEARCH_BUDGET` proposals on descriptions of 8 H100s
SEARCH_CAL_STEPS = 10
SEARCH_TOP_OPS = 4
SEARCH_BUDGET = 1000
SEARCH_SEED = 0
SEARCH_MESHES = (((8,), ("data",)), ((2, 4), ("data", "model")))
# ResNet-50's grounded conv chain: ImageNet's shape at the sweep's batch
SEARCH_RESNET = dict(batch_size=32, image_size=224)
# memory_ledger's live bytes against the allocator's growth across the
# model's compile (its parameters and optimizer slots)
LEDGER_LIVE_REL = 1e-2


def search_calibrate(fa, ls):
    """(a) calibrate_simulator on the encoder (bf16 policy and
    activations, b=32, s=512), the LM (bf16 policy, 16 x 512) and the
    NMT (bf16 activations, f32 policy, b=256, T=40): measured and
    pre-calibration predicted seconds per step, their ratio, and the
    kernels' launches held to layers x (1 warm + SEARCH_CAL_STEPS)."""
    from flexflow_tpu_torch import FFConfig, SGDOptimizer, build_transformer
    from flexflow_tpu_torch.core.precision import dtype_name
    out = {}
    steps = SEARCH_CAL_STEPS
    for name in ("encoder", "lm", "nmt"):
        if name == "encoder":
            m = build_transformer(
                FFConfig(batch_size=TB, seed=0, compute_dtype="bfloat16"),
                batch_size=TB, dtype=torch.bfloat16, device="cuda",
                **TRAIN_ARCH)
            m.compile(optimizer=SGDOptimizer(lr=0.01),
                      loss_type="sparse_categorical_crossentropy",
                      metrics=[])
            batch, table, names, layers = (
                train_batches(1)[0], fa.launches, fa.FLASH_KERNELS,
                TRAIN_ARCH["num_layers"])
        elif name == "lm":
            m = lm_model("bfloat16")
            batch, table, names, layers = (
                lm_batches(1)[0], fa.launches, fa.FLASH_KERNELS,
                LM_ARCH["num_layers"])
        else:
            m = nmt_model(torch.bfloat16, None)
            batch, table, names, layers = (
                nmt_batches(1)[0], ls.launches,
                ("lstm_fwd", "lstm_bwd"), NL)
        table.update(dict.fromkeys(table, 0))
        measured, predicted = m.calibrate_simulator(batch, steps=steps)
        launches = {k: table[k] for k in names}
        want = layers * (steps + 1)
        if launches != dict.fromkeys(names, want):
            raise AssertionError(f"search (a) {name}: launches {launches} "
                                 f"!= {layers} layers x {steps + 1} steps")
        out[name] = {"measured_ms": measured * 1e3,
                     "predicted_ms": predicted * 1e3,
                     "measured_over_predicted": measured / predicted,
                     "time_scale": m.simulator.time_scale,
                     "launches": launches,
                     "policy": dtype_name(m.config.compute_dtype)}
        log(f"search (a) calibrate {name}: measured {measured * 1e3:.4f} "
            f"ms/step (CUDA events, {steps} steps), predicted before "
            f"calibration {predicted * 1e3:.4f} ms, measured/predicted "
            f"{measured / predicted:.3f}; launches {launches} (= {layers}"
            f" layers x {steps + 1} steps)")
        release(m)
    return out


def search_ground(fa, ls):
    """(b) measure_top_ops on the encoder and the NMT: each grounded
    op's measured forward and backward beside its analytic price (the
    attention op runs the flash kernels, the LSTM op the recurrence
    kernels: measure_op checks their launches); then
    conv_in_situ_factor and ResNet-50's grounded conv chain."""
    from flexflow_tpu_torch import FFConfig, build_resnet, build_transformer
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.pconfig import Strategy
    from flexflow_tpu_torch.search import op_measure
    from flexflow_tpu_torch.search.cost_model import op_cost
    from flexflow_tpu_torch.search.measure import calibrated_machine_model
    from flexflow_tpu_torch.search.simulator import Simulator
    mesh = make_mesh((1,), ("data",))
    mm = calibrated_machine_model(mesh)
    out = {"launches": {}}
    fa.launches.update(dict.fromkeys(fa.launches, 0))
    ls.launches.update(dict.fromkeys(ls.launches, 0))
    models = {
        "encoder": build_transformer(
            FFConfig(batch_size=TB, seed=0, compute_dtype="bfloat16",
                     measure_top_ops=SEARCH_TOP_OPS),
            batch_size=TB, dtype=torch.bfloat16, device="cuda",
            **TRAIN_ARCH),
        "nmt": nmt_graph(torch.bfloat16, measure_top_ops=SEARCH_TOP_OPS),
        "resnet50": build_resnet(
            FFConfig(batch_size=SEARCH_RESNET["batch_size"], seed=0,
                     compute_dtype="bfloat16",
                     measure_top_ops=SEARCH_TOP_OPS),
            depth=50, num_classes=1000, device="cuda", **SEARCH_RESNET)}
    out["conv_in_situ_factor"] = op_measure.conv_in_situ_factor()
    wants = {"encoder": "multihead_attention", "nmt": "lstm",
             "resnet50": "conv2d"}
    for name, m in models.items():
        sim = Simulator(m, mesh, mm)
        want = wants[name]
        if want not in {o.op_type for o in m.ops
                        if o.name in sim._measured_set}:
            # the top signatures by analytic time (which move with the
            # calibrated factors) may miss it: ground its priciest op too
            def price(o):
                c = op_cost(o, Strategy().for_op(o.name), mesh, mm)
                return c.fwd + c.bwd
            sim._measured_set.add(max((o for o in m.ops
                                       if o.op_type == want), key=price).name)
        rows = {}
        kinds = set()
        for op in m.ops:
            if op.name not in sim._measured_set:
                continue
            s = Strategy().for_op(op.name)
            a = op_cost(op, s, mesh, mm)
            g = sim._op_cost(op, Strategy())
            sig = op_measure.op_signature(op, 1)
            if sig in kinds:
                continue
            kinds.add(sig)
            rows[op.name] = {"op_type": op.op_type,
                             "analytic_fwd_ms": a.fwd * 1e3,
                             "analytic_bwd_ms": a.bwd * 1e3,
                             "measured_fwd_ms": g.fwd * 1e3,
                             "measured_bwd_ms": g.bwd * 1e3}
            log(f"search (b) ground {name} {op.name} ({op.op_type}): "
                f"measured fwd {g.fwd * 1e3:.4f} bwd {g.bwd * 1e3:.4f} ms, "
                f"analytic fwd {a.fwd * 1e3:.4f} bwd {a.bwd * 1e3:.4f} ms")
        out[name] = {"ops": rows,
                     "grounded_ops": len(sim._measured_set),
                     "step_ms": sim.simulate(Strategy()) * 1e3}
        if want not in {r["op_type"] for r in rows.values()}:
            raise AssertionError(f"search (b) {name}: no {want} op among "
                                 f"the grounded {list(rows)}")
    out["launches"] = {**{k: fa.launches[k] for k in fa.FLASH_KERNELS},
                       **{k: ls.launches[k]
                          for k in ("lstm_fwd", "lstm_bwd")}}
    if not all(out["launches"].values()):
        raise AssertionError(f"search (b): a kernel did not launch while "
                             f"measured: {out['launches']}")
    log(f"search (b) conv_in_situ_factor {out['conv_in_situ_factor']:.4f};"
        f" measurement launches {out['launches']}")
    del models
    torch.cuda.empty_cache()
    return out


def search_drift_memory():
    """(c) fit on the LM (bf16 policy) for 3 epochs of 3 steps with
    telemetry on: drift samples > 0 and the drift report; (d) its
    memory_ledger: live bytes against the allocator's growth across the
    compile, and the activation estimate beside the step's peak."""
    from functools import partial
    from flexflow_tpu_torch import FFConfig, SGDOptimizer, build_transformer_lm
    from flexflow_tpu_torch.core.losses import \
        sparse_categorical_crossentropy
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    m = build_transformer_lm(
        FFConfig(batch_size=LB, seed=0, compute_dtype="bfloat16",
                 telemetry=True),
        batch_size=LB, device="cuda", **LM_ARCH)
    m.compile(optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
              loss_type=partial(sparse_categorical_crossentropy,
                                from_logits=True), metrics=[])
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated() - base
    bs = lm_batches(3)
    x = {k: np.concatenate([b[k] for b in bs]) for k in ("tokens",
                                                          "positions")}
    y = np.concatenate([b["label"] for b in bs])
    torch.cuda.reset_peak_memory_stats()
    hist = m.fit(x, y, epochs=3, verbose=False, shuffle=False)
    peak = torch.cuda.max_memory_allocated() - base
    drift = m.telemetry.drift_snapshot().get("train", {})
    samples = sum(d["count"] for d in drift.values())
    if samples <= 0:
        raise AssertionError(f"search (c): no drift samples ({drift})")
    report = m.telemetry.drift_report()
    c = {"drift": drift, "samples": samples, "report": report,
         "losses": [h["loss"] for h in hist],
         "predicted_ms": m._predicted_step_s()[0] * 1e3}
    log(f"search (c) drift: {samples} samples, {json.dumps(drift)}")
    log(f"search (c) drift report: {json.dumps(report)}")
    ledger = m.memory_ledger()
    ratio = ledger["live_bytes"] / live
    d = {"ledger": ledger, "allocator_live_bytes": live,
         "ledger_vs_live": ratio, "peak_bytes": peak,
         "activation_est_bytes": ledger["activation_est_bytes"],
         "peak_over_live_bytes": peak - live}
    log(f"search (d) memory: ledger live {ledger['live_bytes']:.0f} B vs "
        f"the allocator's {live} B (ratio {ratio:.5f}, limit "
        f"{LEDGER_LIVE_REL}); activation estimate "
        f"{ledger['activation_est_bytes']:.0f} B beside the fit's peak "
        f"above the live bytes {peak - live} B (max_memory_allocated "
        f"{peak + base} B)")
    if abs(ratio - 1.0) > LEDGER_LIVE_REL:
        raise AssertionError(f"search (d): ledger_vs_live {ratio}")
    release(m)
    return c, d


def search_models():
    """The searched models, built on the card and not compiled: the
    encoder and the LM (bf16 policy, parameter parallelism on) and DLRM
    "full" (separate tables, device placement on, the SGD optimizer's
    sparse rows priced as compile would)."""
    import flexflow_tpu_torch as ft
    kw = dict(seed=0, compute_dtype="bfloat16",
              enable_parameter_parallel=True, grad_bucket_mb=0.0)
    enc = ft.build_transformer(ft.FFConfig(batch_size=TB, **kw),
                               batch_size=TB, dtype=torch.bfloat16,
                               device="cuda", **TRAIN_ARCH)
    lm = ft.build_transformer_lm(ft.FFConfig(batch_size=LB, **kw),
                                 batch_size=LB, device="cuda", **LM_ARCH)
    f = DLRM_FULL
    dl = ft.build_dlrm(
        ft.FFConfig(batch_size=f["batch"], seed=0, grad_bucket_mb=0.0,
                    enable_parameter_parallel=True,
                    enable_device_placement=True),
        batch_size=f["batch"], embedding_vocab_sizes=(f["vocab"],)
        * f["tables"], embedding_dim=DLRM_DIM, device="cuda")
    for m in (enc, lm, dl):
        m.optimizer = ft.SGDOptimizer(lr=0.01)
    return {"encoder": enc, "lm": lm, "dlrm": dl}


def search_optimize(outdir):
    """(e) optimize over descriptions of 8 H100s ((8,) data, (2, 4)
    data x model) for the encoder, the LM and DLRM, in both engines
    with one seed: each search's wall, its best simulated step and DP's
    beside it (the winner no slower), the winner's explain_report head,
    a strategy file round trip; then optimize_with_mesh(devices=8) on
    the LM."""
    from flexflow_tpu_torch.parallel import strategy_io
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.pconfig import Strategy
    from flexflow_tpu_torch.search import mcmc
    from flexflow_tpu_torch.search.explain import (explain_placement,
                                                   explain_report)
    from flexflow_tpu_torch.search.simulator import Simulator
    from flexflow_tpu_torch import native
    t0 = time.perf_counter()
    native.get_lib()        # g++ builds the engine here, outside the walls
    out = {"native_build_s": time.perf_counter() - t0}
    log(f"search (e) native engine built from flexflow_tpu_torch/csrc in "
        f"{out['native_build_s']:.2f} s")
    models = search_models()
    for name, m in models.items():
        for shape, axes in SEARCH_MESHES:
            mesh = make_mesh(shape, axes)
            mm = mcmc.search_machine_model(m, mesh)
            key = f"{name} {'x'.join(map(str, shape))}"
            cell = {}
            for engine in ("python", "native"):
                sim = Simulator(m, mesh, mm)
                dp = sim.simulate(Strategy())
                t0 = time.perf_counter()
                best = mcmc.optimize(m, budget=SEARCH_BUDGET, mesh=mesh,
                                     seed=SEARCH_SEED, simulator=sim,
                                     use_native=engine == "native",
                                     chains=1)
                wall = time.perf_counter() - t0
                cost = sim.simulate(best)
                stats = m.search_stats
                if stats["engine"] != engine:
                    raise AssertionError(f"search (e) {key}: ran "
                                         f"{stats['engine']}, not {engine}")
                if not cost <= dp:
                    raise AssertionError(f"search (e) {key} {engine}: "
                                         f"best {cost} slower than DP {dp}")
                sharded = sorted({f"{op}:{ax}" for op, st in
                                  best.op_strategies.items()
                                  for ax, v in st.axis_map.items()
                                  if v == "model" or ax == "__devices__"})
                cell[engine] = {"wall_s": wall, "best_ms": cost * 1e3,
                                "dp_ms": dp * 1e3,
                                "proposals": stats["proposals"],
                                "proposals_per_sec":
                                    stats["proposals_per_sec"],
                                "sharded": sharded[:12],
                                "n_sharded": len(sharded)}
                log(f"search (e) {key} {engine}: {SEARCH_BUDGET} proposals"
                    f" in {wall:.3f} s, best {cost * 1e3:.4f} ms vs DP "
                    f"{dp * 1e3:.4f} ms; model/pinned maps {len(sharded)}"
                    f" {sharded[:6]}")
            info = explain_placement(m, mesh, best, simulator=sim)
            head = explain_report(info).splitlines()[:6]
            cell["explain_head"] = head
            for line in head:
                log(f"search (e) {key} explain: {line}")
            path = outdir / f"strategy_{name}_{'x'.join(map(str, shape))}"
            best.save(str(path) + ".json")
            back = Strategy.load(str(path) + ".json")
            # the reference's text format keeps what divides the mesh:
            # its round trip is a fixed point (load, save, same text)
            strategy_io.save_strategies_to_file(m, best, mesh,
                                                str(path) + ".txt")
            text = strategy_io.load_strategies_from_file(
                m, mesh, str(path) + ".txt")
            strategy_io.save_strategies_to_file(m, text, mesh,
                                                str(path) + ".2.txt")
            same = ({k: v.axis_map for k, v in back.op_strategies.items()}
                    == {k: v.axis_map for k, v in best.op_strategies.items()}
                    and sim.simulate(back) == cost
                    and Path(str(path) + ".txt").read_text()
                    == Path(str(path) + ".2.txt").read_text())
            if not same:
                raise AssertionError(f"search (e) {key}: the strategy "
                                     f"file round trip changed it")
            cell["round_trip"] = same
            out[key] = cell
    lm = models["lm"]
    t0 = time.perf_counter()
    strat, mesh = mcmc.optimize_with_mesh(lm, budget=SEARCH_BUDGET,
                                          seed=SEARCH_SEED, devices=8,
                                          chains=1)
    wall = time.perf_counter() - t0
    sim = Simulator(lm, mesh, mcmc.search_machine_model(lm, mesh))
    out["lm optimize_with_mesh"] = {
        "mesh": dict(mesh.shape), "wall_s": wall,
        "best_ms": sim.simulate(strat) * 1e3,
        "dp_ms": sim.simulate(Strategy()) * 1e3,
        "mesh_shapes": lm.search_stats["mesh_shapes"]}
    log(f"search (e) lm optimize_with_mesh(devices=8): mesh "
        f"{dict(mesh.shape)} of {lm.search_stats['mesh_shapes']} shapes "
        f"in {wall:.3f} s, best {out['lm optimize_with_mesh']['best_ms']:.4f}"
        f" ms vs DP on it {out['lm optimize_with_mesh']['dp_ms']:.4f} ms")
    del models
    return out


def search_phase(fa, ls):
    """The search stack on the card: (a) calibration, (b) grounding in
    measured ops, (c) fit's drift samples, (d) the memory ledger, (e)
    strategy searches over descriptions of 8 H100s. Returns its numbers
    and the kernels' launches of (a) and (b)."""
    from flexflow_tpu_torch.search.measure import calibrated_machine_model
    t0 = time.perf_counter()
    outdir = HERE / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    calibrated_machine_model()      # measured once, kept per card
    res = {"calibration": search_calibrate(fa, ls)}
    res["grounding"] = search_ground(fa, ls)
    res["drift"], res["memory"] = search_drift_memory()
    res["search"] = search_optimize(outdir)
    res["phase_s"] = time.perf_counter() - t0
    log(f"search phase: {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------- mesh
# the executing mesh: held steps a run, timed captured steps of
# (a), the search budget of (c); (b) against the one-rank card run at
# f32 (the global sums of two ranks' partial sums in another order)
MESH_STEPS = 3
MESH_B_STEPS = 2
MESH_TIMED = 10
MESH_ROUNDS = 4
MESH_SEARCH_BUDGET = 200
MESH_LOSS_REL = 1e-5
MESH_WEIGHT_ABS = 1e-5
# (a)'s explicit bucket size: 4 buckets of the LM's 208 MB of dense f32
# masters (the embedding tables train densely under momentum): the token
# table alone, then about two blocks a bucket, the last with the head
MESH_BUCKET_MB = 25.0


def mesh_ms(m, batch, n):
    """Mean wall ms of n train steps between CUDA events, after a
    synchronize (the step's device work and its host work both)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        m.train_batch(batch)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def mesh_lm_loss():
    from functools import partial
    from flexflow_tpu_torch.core.losses import \
        sparse_categorical_crossentropy
    return partial(sparse_categorical_crossentropy, from_logits=True)


def mesh_rank_a(steps, timed):
    """(a) on one NCCL rank of one card each: the README's LM at full
    width, bf16 policy, captured, on ``default_mesh()`` with
    grad_bucket_mb auto, 0 and MESH_BUCKET_MB (auto resolves to 0 on a
    data axis of one rank, as JAX's does: the explicit size runs the
    bucket hooks inside the capture), against the same model without
    a mesh. At world 1 the losses and masters must be bit-identical."""
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel import collectives as C
    from flexflow_tpu_torch.parallel.mesh import default_mesh
    world = dist.get_world_size()
    data = lm_batches(steps + 1)
    out = {"backend": str(dist.get_backend()), "world": world,
           "rank": dist.get_rank()}
    ref = lm_model("bfloat16")
    ref_losses = [float(ref.train_batch(b)["loss"]) for b in data[:steps]]
    ref_w = weights_of(ref)
    models = {"nomesh": ref}
    for mb in (None, 0.0, MESH_BUCKET_MB):
        key = "auto" if mb is None else f"{mb:g}"
        m = lm_model("bfloat16", mesh=default_mesh(), grad_bucket_mb=mb)
        losses = [float(m.train_batch(b)["loss"]) for b in data[:steps]]
        cell = {"losses": losses, "ref_losses": ref_losses}
        if world == 1:
            wdiff, worst = max_weight_diff(weights_of(m), ref_w)
            cell["max_weight_diff"] = wdiff
            if losses != ref_losses or wdiff != 0.0:
                raise AssertionError(
                    f"mesh (a) bucket {key}: the one-rank mesh changed the "
                    f"arithmetic: losses {losses} vs {ref_losses}, weights "
                    f"by {wdiff} at {worst}")
        C.reset_counts()
        mesh_ms(m, data[steps], timed)
        cell["collectives_per_step"] = {
            k: v / timed for k, v in C.launches.items() if v}
        info = m.executor.grad_bucket_info()
        cell["buckets"] = info["count"]
        cell["bucket_mb"] = info["bucket_mb"]
        cell["captures"] = m.compile_counts()
        out[key] = cell
        models[key] = m
    # the step times in interleaved rounds (no mesh first, then last),
    # the median of each model's rounds
    order = list(models)
    rounds = {k: [] for k in order}
    for r in range(MESH_ROUNDS):
        for k in (order if r % 2 == 0 else order[::-1]):
            rounds[k].append(mesh_ms(models[k], data[steps], timed))
    out["nomesh_step_ms"] = statistics.median(rounds["nomesh"])
    out["nomesh_rounds"] = rounds["nomesh"]
    for k in order[1:]:
        out[k]["step_ms"] = statistics.median(rounds[k])
        out[k]["rounds"] = rounds[k]
    for m in models.values():
        release(m)
    return out


def mesh_rank_b(kind, steps):
    """(b) on two gloo ranks of one card, eager: ``dp`` is the dropout
    LM at full width, f32 policy, on (2,) data with ZeRO-1; ``tp`` the
    same on (1, 2) data x model under megatron_strategy (4 of 8 heads a
    rank). Rank 0 also trains the one-rank card run (no mesh) from the
    same weights and keys; the global weights are held against it."""
    import torch.distributed as dist
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.kernels import dropout as kd
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import collectives as C
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.pconfig import megatron_strategy
    rank = dist.get_rank()
    data = lm_batches(steps)
    mesh, strat, zero = ((make_mesh((2,), ("data",)), None, True)
                         if kind == "dp" else
                         (make_mesh((1, 2), ("data", "model")),
                          megatron_strategy(), False))

    def build(mesh=None, strategy=None):
        m = dropout_lm_graph(LB, compute_dtype="float32", mesh=mesh,
                             strategy=strategy, **LM_ARCH)
        m.config.zero_optimizer_sharding = zero and mesh is not None
        m.compile(optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
                  loss_type=mesh_lm_loss(), metrics=[], capture=False)
        return m

    out = {"kind": kind, "rank": rank}
    ref = None
    if rank == 0:
        ref = build()
        out["ref_losses"] = [float(ref.train_batch(b)["loss"])
                             for b in data]
        ref_w = {op: {k: v.detach().cpu() for k, v in p.items()}
                 for op, p in ref.state.params.items()}
        release(ref)
        del ref
    dist.barrier()
    m = build(mesh, strat)
    fl0 = dict(fa.launches)
    dr0 = dict(kd.launches)
    C.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["losses"] = [float(m.train_batch(b)["loss"]) for b in data]
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3 / steps
    out["flash_launches"] = {k: fa.launches[k] - fl0.get(k, 0)
                             for k in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    out["dropout_launches"] = {k: kd.launches[k] - dr0[k]
                               for k in kd.launches}
    out["collectives_per_step"] = {k: v / steps
                                   for k, v in C.launches.items() if v}
    out["staged_mb_per_step"] = sum(C.staged_bytes.values()) / steps / 1e6
    out["heads_local"] = int(m.state.params["layer0_attn"]["wq"].shape[1])
    out["zero_slots"] = len(m.executor._zero_dims)
    glob = {op.name: m.get_weights(op.name) for op in m.ops
            if op.weight_specs()}
    if rank == 0:
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(out["losses"], out["ref_losses"]))
        wdiff = max(float(np.abs(glob[op][k] - ref_w[op][k].numpy()).max())
                    for op in glob for k in glob[op])
        out["max_loss_rel"], out["max_weight_abs"] = rel, wdiff
        if not (rel <= MESH_LOSS_REL and wdiff <= MESH_WEIGHT_ABS):
            raise AssertionError(
                f"mesh (b) {kind}: against the one-rank card run, loss "
                f"rel {rel} (limit {MESH_LOSS_REL}), weights {wdiff} "
                f"(limit {MESH_WEIGHT_ABS})")
    n_layers = LM_ARCH["num_layers"]
    want = n_layers * steps
    if any(v != want for v in out["flash_launches"].values()):
        raise AssertionError(f"mesh (b) {kind}: flash launches "
                             f"{out['flash_launches']}, want {want} each")
    want_d = 2 * n_layers * steps
    if any(v != want_d for v in out["dropout_launches"].values()):
        raise AssertionError(f"mesh (b) {kind}: dropout launches "
                             f"{out['dropout_launches']}, want {want_d}")
    release(m)
    return out


def mesh_rank_c(budget, steps):
    """(c) compile(search_budget=...) of the LM on (b)'s (1, 2) mesh:
    the search prices the card's calibrated machine model and compile
    executes its winner, the same on both ranks."""
    import torch.distributed as dist
    from flexflow_tpu_torch import (FFConfig, SGDOptimizer,
                                    build_transformer_lm)
    from flexflow_tpu_torch.parallel import collectives as C
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.search.explain import (explain_placement,
                                                   explain_report)
    from flexflow_tpu_torch.search.mcmc import search_machine_model
    from flexflow_tpu_torch.search.simulator import Simulator
    mesh = make_mesh((1, 2), ("data", "model"))
    cfg = FFConfig(batch_size=LB, seed=0, search_budget=budget,
                   search_chains=1, enable_parameter_parallel=True)
    m = build_transformer_lm(cfg, batch_size=LB, device="cuda", mesh=mesh,
                             **LM_ARCH)
    t0 = time.perf_counter()
    m.compile(optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
              loss_type=mesh_lm_loss(), metrics=[], capture=False)
    search_s = time.perf_counter() - t0
    maps = {op: dict(st.axis_map)
            for op, st in sorted(m.strategy.op_strategies.items())}
    every = C.gather_objects(json.dumps(maps, sort_keys=True),
                             m.executor.bm, "model")
    if len(set(every)) != 1:
        raise AssertionError("mesh (c): the ranks' searches disagree")
    sim = Simulator(m, mesh, search_machine_model(m, mesh))
    sim_ms = sim.simulate(m.strategy) * 1e3
    head = explain_report(explain_placement(m, mesh, m.strategy,
                                            simulator=sim)).splitlines()[:6]
    data = lm_batches(steps + 1)
    m.train_batch(data[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(m.train_batch(b)["loss"]) for b in data[1:]]
    measured = (time.perf_counter() - t0) * 1e3 / steps
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mesh (c): losses {losses}")
    split = sorted(f"{op}:{ax}" for op, am in maps.items()
                   for ax, v in am.items() if v == "model")
    out = {"search_s": search_s, "sim_step_ms": sim_ms,
           "measured_eager_step_ms": measured, "explain_head": head,
           "model_maps": len(split), "model_maps_head": split[:8],
           "losses": losses}
    release(m)
    return out


def mesh_nccl_two_ranks():
    t = torch.ones(4, device="cuda")
    import torch.distributed as dist
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return t.tolist()


def mesh_phase(card: str):
    """The executing mesh on the card (see the module docstring): (a)
    NCCL, one rank per card; (b) two gloo ranks on the one card, after
    NCCL's verdict on two ranks on one device; (c) the search's winner
    executed on (b)'s mesh. The ranks are processes of their own,
    spawned after every kernel was built (they load the parent's
    builds)."""
    import tempfile
    from flexflow_tpu_torch import native
    from flexflow_tpu_torch.parallel.launch import RankPool
    from flexflow_tpu_torch.search.measure import calibrated_machine_model
    t0 = time.perf_counter()
    calibrated_machine_model()      # on disk for the ranks' searches
    native.get_lib()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="ff_mesh_"))
    res = {}
    world = torch.cuda.device_count()
    with RankPool(world, str(tmp / "a"), backend="nccl", device="cuda",
                  threads=0, timeout_s=600) as pool:
        ra = pool.run(mesh_rank_a, MESH_STEPS, MESH_TIMED)
    res["a"] = ra[0]
    a = ra[0]
    for key in ("auto", "0", f"{MESH_BUCKET_MB:g}"):
        c = a[key]
        log(f"mesh (a) backend {a['backend']} world {a['world']} bucket "
            f"{key} ({c['bucket_mb']:.3f} MB, {c['buckets']} buckets): "
            f"captured step {c['step_ms']:.3f} ms vs no mesh "
            f"{a['nomesh_step_ms']:.3f} ms (medians of {MESH_ROUNDS} "
            f"interleaved rounds of {MESH_TIMED} steps; {card}); "
            f"collectives a step "
            f"{c['collectives_per_step']}; losses bit-identical to the "
            f"no-mesh run: {c['losses'] == c['ref_losses']}")
    try:
        with RankPool(2, str(tmp / "n"), backend="nccl", device="cuda",
                      threads=0, timeout_s=120) as pool:
            pool.run(mesh_nccl_two_ranks)
        verdict, backend_b = "NCCL accepted two ranks on one card", "nccl"
    except Exception as e:           # noqa: BLE001 - printed: NCCL's verdict
        lines = [ln.strip() for ln in str(e).splitlines()
                 if "rror" in ln or "uplicate" in ln]
        verdict, backend_b = " | ".join(lines[-2:])[:400], "gloo"
    res["nccl_two_ranks_one_card"] = verdict
    log(f"mesh (b) NCCL with two ranks on one card: {verdict}")
    log(f"mesh (b) two ranks on the one card over {backend_b}"
        + (", eager; every collective staged through pinned host memory"
           if backend_b == "gloo" else ""))
    with RankPool(2, str(tmp / "b"), backend=backend_b, device="cuda",
                  threads=0, timeout_s=600) as pool:
        for kind in ("dp", "tp"):
            rb = pool.run(mesh_rank_b, kind, MESH_B_STEPS)
            res[f"b_{kind}"] = rb
            r0 = rb[0]
            log(f"mesh (b) {kind}: vs the one-rank card run loss rel "
                f"{r0['max_loss_rel']:.3e}, weights abs "
                f"{r0['max_weight_abs']:.3e}; flash launches a rank "
                f"{[r['flash_launches'] for r in rb]} on "
                f"{r0['heads_local']} heads; dropout "
                f"{[r['dropout_launches'] for r in rb]}; staged "
                f"{[round(r['staged_mb_per_step'], 3) for r in rb]} MB a "
                f"step; collectives a step {r0['collectives_per_step']}; "
                f"eager step {[round(r['step_ms'], 1) for r in rb]} ms; "
                f"ZeRO-1 slots {r0['zero_slots']}")
        rc = pool.run(mesh_rank_c, MESH_SEARCH_BUDGET, MESH_B_STEPS)
    c = res["c"] = rc[0]
    for line in c["explain_head"]:
        log(f"mesh (c) explain: {line}")
    log(f"mesh (c) search {MESH_SEARCH_BUDGET} proposals in "
        f"{c['search_s']:.2f} s; winner's model splits {c['model_maps']} "
        f"{c['model_maps_head']}; simulated step {c['sim_step_ms']:.3f} ms"
        f" vs measured eager step {c['measured_eager_step_ms']:.1f} ms "
        f"(two {backend_b} ranks on one card"
        + (", collectives staged through host memory: the measured step is"
           " no speed" if backend_b == "gloo" else "") + ")")
    res["phase_s"] = time.perf_counter() - t0
    log(f"mesh phase: {res['phase_s']:.1f} s")
    return res


# -------------------------------------------- tensor-parallel serving
TP_DEGREE = 2
TP_NEW = 32
TP_INT8_MARGIN = 0.05   # the int8 pool's kv_tie_margin
# int8 rows of a t = 2 rank against the one-device engine's: every code
# within one grid step and every scale within SCALE_REL relative (the
# tier-1 test's limits: a code flipped at a rounding boundary moves the
# next layer's input by a grid step, and the flips compound); layer 0 bit
# for bit unless the q/k/v witness shows the rank's projection rounding
# differently, and then at most LAYER0_CODES_OFF of its codes a step off
# and its scales within LAYER0_SCALE_REL
TP_SCALE_REL = 1e-2
TP_LAYER0_CODES_OFF = 1e-4
TP_LAYER0_SCALE_REL = 1e-5
# f32 rows a t = 2 engine exports against a one-device engine's export of
# the same prompt, relative to the layer's largest |row|
TP_SHIP_REL = 1e-4


def tp_lm():
    """The README's LM at full width on this process's card, f32, for
    inference, from the port's seeded initializers (the same weights in
    every process)."""
    from flexflow_tpu_torch import FFConfig, build_transformer_lm
    from flexflow_tpu_torch.config import CompMode
    m = build_transformer_lm(FFConfig(batch_size=1, seed=0), batch_size=1,
                             device="cuda", **LM_ARCH)
    m.compile(comp_mode=CompMode.INFERENCE)
    return m


def tp_pool_rows(eng):
    """The engine's page pool tensors as numpy (int8 codes, f32
    scales)."""
    return [t.cpu().numpy() for t in eng._pool_args()]


def tp_rank_serve(kv_dtype):
    """(a), (b) on one gloo rank: the 8 greedy prompts through a t = 2
    engine, eager (gloo stages every collective through pinned host
    memory). Counts from 0 after warmup: kernel 1's launches on this
    rank, the collectives and the bytes staged; the eager step walls."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr
    from flexflow_tpu_torch.parallel import collectives as C
    from flexflow_tpu_torch.serve import ServeEngine
    lm = tp_lm()
    greedy, _ = serve_prompts(LM_ARCH["vocab_size"])
    eng = ServeEngine(lm, FFConfig(kv_dtype=kv_dtype), device="cuda",
                      tensor_parallel=TP_DEGREE, capture=False)
    counts = eng.warmup()
    torch.cuda.synchronize()
    pr.launches = 0
    C.reset_counts()
    out = eng.generate(greedy, TP_NEW)
    st = eng.last_stats
    res = {"out": out, "launches": pr.launches, "steps": st["steps"],
           "heads_local": eng.cache_cfg.heads_per_device,
           "collectives": dict(C.launches),
           "staged": dict(C.staged_bytes), "sharding": st["sharding"],
           "step_ms": 1e3 * st["wall_s"] / st["steps"],
           "captures_stable": eng.compile_counts() == counts,
           "lockstep_checks": eng._lockstep.checks}
    if eng.kv_quantized:
        res["rows"] = tp_pool_rows(eng)
    return res


def tp_int8_rows(ranks, ref, h):
    """Each rank's int8 pool (codes, scales) against the one-device
    pool's rows of the rank's heads, by layer: the codes off by a grid
    step and the most steps, the largest relative scale difference and
    where it sits (layer, page, offset, head: the two scales), and
    whether the layer is bit for bit."""
    L = ref[0].shape[0]
    out = {"codes": 2 * int(ref[0][0].size),
           "code_off": [0] * L, "code_steps": 0, "scale_rel": [0.0] * L,
           "bit_equal": [True] * L, "worst_at": None}
    worst = -1.0
    for c, (kq, vq, ks, vs) in enumerate(ranks):
        sl = slice(c * h, (c + 1) * h)
        for mine, whole in ((kq, ref[0]), (vq, ref[1])):
            d = np.abs(mine.astype(np.int32)
                       - whole[..., sl, :].astype(np.int32))
            out["code_steps"] = max(out["code_steps"], int(d.max()))
            for layer in range(L):
                out["code_off"][layer] += int((d[layer] > 0).sum())
                out["bit_equal"][layer] &= not d[layer].any()
        for mine, whole in ((ks, ref[2]), (vs, ref[3])):
            part = whole[..., sl]
            rel = np.abs(mine - part) / np.maximum(np.abs(part), 1e-30)
            for layer in range(L):
                m = float(rel[layer].max())
                out["scale_rel"][layer] = max(out["scale_rel"][layer], m)
                out["bit_equal"][layer] &= bool(
                    np.array_equal(mine[layer], part[layer]))
                if m > worst:
                    worst = m
                    at = np.unravel_index(int(rel[layer].argmax()),
                                          rel[layer].shape)
                    out["worst_at"] = {
                        "layer": layer, "page": int(at[0]),
                        "offset": int(at[1]), "head": c * h + int(at[2]),
                        "scales": [float(mine[layer][at]),
                                   float(part[layer][at])]}
    return out


def tp_gemm_witness(eng, greedy):
    """Where a t = 2 rank's layer-0 K/V can part from the one-device
    engine's: the same f32 rows (the LayerNorm of the prompts' embedded
    tokens, the mixed step's width T of them) projected onto one rank's
    heads of wk and wv (a contiguous (E, H/t, D) block, as _shard_params
    copies it) against the matching slice of the projection onto all
    heads. The inputs of that projection agree bit for bit (the sharded
    embedding's all-reduce adds exact zeros); cuBLAS may pick another
    kernel, and so another summation order, for the narrower matrix.
    Returns the elements that differ, the largest relative difference
    and the largest |difference| over the largest |element|, per rank
    and matrix."""
    lm, T = eng.lm, eng.mixed_width
    flat = [t for p in greedy for t in p][:T]
    dev = eng.device
    tokens = torch.tensor(flat, dtype=torch.int32, device=dev)
    positions = torch.arange(T, device=dev) % LM_ARCH["max_seq_len"]
    h = HEADS // TP_DEGREE
    out = {"elements": T * h * HEAD_DIM, "differ": {}, "max_rel": {},
           "max_over_max": {}}
    with torch.no_grad():
        x = lm.attn_in(0, lm.embed(tokens, positions))
        for w in ("wk", "wv"):
            kernel = lm.params["layer0_attn"][w]
            whole = torch.einsum("...e,ehd->...hd", x, kernel)
            for c in range(TP_DEGREE):
                block = kernel.narrow(1, c * h, h).clone(
                    memory_format=torch.contiguous_format)
                part = torch.einsum("...e,ehd->...hd", x, block)
                ref = whole[:, c * h:(c + 1) * h]
                d = (part - ref).abs()
                out["differ"][f"{w} rank {c}"] = int((d > 0).sum())
                out["max_rel"][f"{w} rank {c}"] = float(
                    (d / ref.abs().clamp_min(1e-30)).max())
                out["max_over_max"][f"{w} rank {c}"] = float(
                    d.max() / ref.abs().max())
    return out


def tp_ship_rows(ship, own):
    """A t = 2 engine's shipment against a one-device engine's export of
    the same prompt, by layer: the largest |difference| over the layer's
    largest |row|, and whether the layer's rows are bit for bit."""
    rel, bit = [], []
    for layer in range(ship.k_rows.shape[0]):
        worst, same = 0.0, True
        for a, b in ((ship.k_rows, own.k_rows), (ship.v_rows, own.v_rows)):
            worst = max(worst, float(np.abs(a[layer] - b[layer]).max()
                                     / max(np.abs(b[layer]).max(), 1e-30)))
            same &= bool(np.array_equal(a[layer], b[layer]))
        rel.append(worst)
        bit.append(same)
    return {"rel": rel, "bit_equal": bit}


def tp_rank_handoff():
    """(c) on one gloo rank: a 1:1 cluster of t = 2 roles (serve_mesh
    "2") against the t = 2 unified engine, and a t = 2 export imported
    into a one-device engine on this rank's card and held against a
    one-device engine's own export of the same prompt (a misordered or
    repeated head block in the export's all-gather would show there)."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr
    from flexflow_tpu_torch.serve import DisaggCluster, ServeEngine
    lm = tp_lm()
    greedy, _ = serve_prompts(LM_ARCH["vocab_size"])
    cfg = FFConfig(serve_mesh=str(TP_DEGREE), serve_spec_decode=False)
    res = {}
    with DisaggCluster(lm, config=cfg, device="cuda", capture=False) as cl:
        counts = cl.warmup()
        pr.launches = 0
        res["cluster"] = cl.generate(greedy, TP_NEW)
        res["cluster_launches"] = pr.launches
        res["degrees"] = [e.tp for _, e in cl.engines()]
        res["cluster_stable"] = cl.compile_counts() == counts
        res["handoff_pages"] = cl.stats["handoff_pages"]
    uni = ServeEngine(lm, cfg, device="cuda", capture=False)
    uni.warmup()
    res["unified"] = uni.generate(greedy, TP_NEW)
    one = ServeEngine(lm, FFConfig(serve_spec_decode=False), device="cuda",
                      capture=False)
    one.warmup()
    one.warmup_handoff()
    ships = []
    uni.generate([greedy[4]], 1, on_finish=lambda r: ships.append(
        uni.export_kv(r.slot, r.context)))
    ship = ships[0]
    res["ship_pages"] = ship.num_pages
    res["written"] = one.import_kv(ship)
    pages = [one.cache._page_of_hash[k] for k in ship.keys]
    got = [t[:, pages].cpu().numpy() for t in one._pool_args()]
    res["rows_equal"] = all(np.array_equal(g, r) for g, r in
                            zip(got, (ship.k_rows, ship.v_rows)))
    ref = ServeEngine(lm, FFConfig(serve_spec_decode=False), device="cuda",
                      capture=False)
    ref.warmup()
    owns = []
    ref.generate([greedy[4]], 1, on_finish=lambda r: owns.append(
        ref.export_kv(r.slot, r.context)))
    own = owns[0]
    res["keys_equal"] = list(own.keys) == list(ship.keys) \
        and own.k_rows.shape == ship.k_rows.shape
    res["ship_rows"] = tp_ship_rows(ship, own) if res["keys_equal"] \
        else None
    return res


def tp_kernel_check(pr, heads_list=(HEADS // 2, HEADS // 4),
                    pages=("f32", "int8"), tag="tp_serve (d)"):
    """(d) kernel 1 at H = 4 and H = 2 (the heads of a rank at t = 2 and
    t = 4) on the mixed step's other shapes, f32 and int8 pages, against
    its plain version; timed beside it and its bound. ``heads_list`` and
    ``pages`` pick the cells, ``tag`` names the phase in the log."""
    dev = torch.device("cuda")
    scale = 1.0 / math.sqrt(HEAD_DIM)
    out = {}
    for heads in heads_list:
        for name, dtype, tol in (("f32", torch.float32, F32_TOL),
                                 ("int8", torch.int8, QUANT_REL_TOL)):
            if name not in pages:
                continue
            quant = dtype == torch.int8
            args = kernel_inputs(torch.float32, dev, heads=heads)
            kw = {}
            if quant:
                q, kp, vp, *rest = args
                kq, ks = pr.quantize_kv_rows(kp, dtype)
                vq, vs = pr.quantize_kv_rows(vp, dtype)
                args = (q, kq, vq, *rest)
                kw = {"k_scales": ks, "v_scales": vs}
            got = pr.paged_ragged_v2_cuda(*args, scale, **kw)
            torch.cuda.synchronize()
            ref = pr.ragged_attention_ref(*args, scale, **kw)
            err, rel = check_err(f"paged_ragged_v2 H={heads} {name}", got,
                                 ref, tol, relative=quant)
            k_ms = cuda_ms(lambda: pr.paged_ragged_v2_cuda(
                *args, scale, **kw), 50)
            p_ms = cuda_ms(lambda: pr.ragged_attention_ref(
                *args, scale, **kw), 5)
            b_ms, b_by = attention_bound(args[0], args[1], *args[3:])
            out[f"H={heads} {name}"] = {
                "max_abs_err": err, "err_over_max_ref": rel, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
            log(f"{tag} kernel paged_ragged_v2 [{name} pages, "
                f"T=520 H={heads} D=64 ps=16 pp=32 P=257]: max_abs_err="
                f"{err:.3g} err/max|ref|={rel:.3g} (tol {tol}"
                f"{' relative' if quant else ''}) kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
            del args, kw, got, ref
    return out


def tp_serve_phase(pr, card: str):
    """Tensor-parallel serving on the card (see the module docstring):
    two gloo ranks sharing it run t = 2 engines, eager; the one-device
    captured engine of this process is their reference."""
    import tempfile
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.parallel.launch import RankPool
    from flexflow_tpu_torch.serve import ServeEngine
    t0 = time.perf_counter()
    res = {}
    res["kernel"] = tp_kernel_check(pr)
    greedy, _ = serve_prompts(LM_ARCH["vocab_size"])
    lm = tp_lm()
    one = {}
    for kv in ("float32", "int8"):
        eng = ServeEngine(lm, FFConfig(kv_dtype=kv), device="cuda")
        eng.warmup()
        pr.launches = 0
        out = eng.generate(greedy, TP_NEW)
        one[kv] = {"out": out, "steps": eng.last_stats["steps"],
                   "launches": pr.launches, "eng": eng,
                   "rows": tp_pool_rows(eng) if eng.kv_quantized else None}
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="ff_tp_"))
    with RankPool(TP_DEGREE, str(tmp / "init"), backend="gloo",
                  device="cuda", threads=0, timeout_s=600) as pool:
        ranks = {kv: pool.run(tp_rank_serve, kv)
                 for kv in ("float32", "int8")}
        hand = pool.run(tp_rank_handoff)
    L = LM_ARCH["num_layers"]
    res["witness"] = wit = tp_gemm_witness(one["float32"]["eng"], greedy)
    witness_differs = any(wit["differ"].values())
    log(f"tp_serve witness [{card}]: layer 0's k/v projection of "
        f"{one['float32']['eng'].mixed_width} f32 rows onto one rank's "
        f"{HEADS // TP_DEGREE} heads against the slice of the projection "
        f"onto all {HEADS}: elements "
        f"that differ {wit['differ']} of {wit['elements']} each, largest "
        f"relative difference "
        f"{ {k: f'{v:.3g}' for k, v in wit['max_rel'].items()} }, largest "
        f"|difference| / max|element| "
        f"{ {k: f'{v:.3g}' for k, v in wit['max_over_max'].items()} }")
    for kv, rs in ranks.items():
        ref = one[kv]
        eng = ref["eng"]
        if any(r["out"] != rs[0]["out"] for r in rs):
            raise AssertionError(f"tp_serve {kv}: the ranks' tokens differ")
        margin = PARITY_MARGIN if kv == "float32" else TP_INT8_MARGIN
        exact = eng.assert_token_parity(greedy, rs[0]["out"], ref["out"],
                                        margin=margin)
        if kv == "float32" and exact != len(greedy):
            raise AssertionError(
                f"tp_serve (a) f32: {exact}/{len(greedy)} greedy streams "
                f"token-identical to the one-device engine, want all")
        steps = rs[0]["steps"]
        for r in rs:
            if r["launches"] != L * steps or not r["captures_stable"]:
                raise AssertionError(
                    f"tp_serve {kv}: kernel 1 launched {r['launches']} "
                    f"times, want {L} layers x {steps} steps")
        r0 = rs[0]
        tie = "" if kv == "float32" else \
            f" (the rest diverge at a tie <= {margin})"
        coll = {k: v / steps for k, v in r0["collectives"].items() if v}
        staged = {k: v / steps / 2**20 for k, v in r0["staged"].items()}
        cell = {"exact_streams": exact, "streams": len(greedy),
                "steps": steps, "one_device_steps": ref["steps"],
                "launches": [r["launches"] for r in rs],
                "one_device_launches": ref["launches"],
                "heads_local": r0["heads_local"],
                "collectives_per_step": coll,
                "staged_mib_per_step": staged,
                "analytic_collective_mib_per_step":
                    r0["sharding"]["collective_bytes_per_step"] / 2**20,
                "eager_step_ms": [r["step_ms"] for r in rs]}
        log(f"tp_serve ({'a' if kv == 'float32' else 'b'}) {kv} pages, t="
            f"{TP_DEGREE} on two gloo ranks sharing the card [{card}]: "
            f"{exact}/{len(greedy)} greedy streams token-identical to the "
            f"one-device captured engine{tie}; steps {steps} (one device "
            f"{ref['steps']}); kernel "
            f"1 launches a rank {cell['launches']} on {r0['heads_local']} "
            f"heads (= {L} layers x {steps} steps; one device "
            f"{ref['launches']} on {HEADS}); collectives a step {coll}; "
            f"staged through host memory a step "
            f"{ {k: round(v, 3) for k, v in staged.items()} } MiB beside "
            f"the analytic payload "
            f"{cell['analytic_collective_mib_per_step']:.3f} MiB; eager "
            f"step {[round(x, 1) for x in cell['eager_step_ms']]} ms "
            f"(staged through the host: no speed)")
        if kv == "int8":
            h = HEADS // TP_DEGREE
            cell["rows"] = rows = tp_int8_rows(
                [r["rows"] for r in rs], ref["rows"], HEADS // TP_DEGREE)
            log(f"tp_serve (b) int8 rows against the one-device engine's "
                f"rows of each rank's heads, by layer: codes off by a "
                f"grid step {rows['code_off']} of {rows['codes']} (at most "
                f"{rows['code_steps']} step), scale rel max "
                f"{[f'{x:.3g}' for x in rows['scale_rel']]} (worst at "
                f"{rows['worst_at']}), bit for bit {rows['bit_equal']}")
            bad = []
            if rows["code_steps"] > 1:
                bad.append(f"a code {rows['code_steps']} steps off")
            if max(rows["scale_rel"]) > TP_SCALE_REL:
                bad.append(f"scales {max(rows['scale_rel']):.3g} "
                           f"relative off (limit {TP_SCALE_REL})")
            if not witness_differs and not rows["bit_equal"][0]:
                bad.append("layer 0 not bit for bit though the rank's "
                           "q/k/v projection rounds as the whole one")
            if rows["code_off"][0] > TP_LAYER0_CODES_OFF * rows["codes"]:
                bad.append(f"layer 0: {rows['code_off'][0]} codes off "
                           f"(limit {TP_LAYER0_CODES_OFF} of "
                           f"{rows['codes']})")
            if rows["scale_rel"][0] > TP_LAYER0_SCALE_REL:
                bad.append(f"layer 0 scales {rows['scale_rel'][0]:.3g} "
                           f"relative off (limit {TP_LAYER0_SCALE_REL})")
            if bad:
                raise AssertionError(f"tp_serve (b) int8 rows: {bad}; "
                                     f"{rows}")
        res["f32" if kv == "float32" else kv] = cell
    h0 = hand[0]
    for r in hand:
        sr = r["ship_rows"]
        ship_ok = sr is not None and max(sr["rel"]) <= TP_SHIP_REL \
            and (witness_differs or sr["bit_equal"][0])
        if r["cluster"] != r["unified"] or r["cluster"] != h0["cluster"] \
                or r["degrees"] != [TP_DEGREE] * 2 \
                or not r["cluster_stable"] or not r["rows_equal"] \
                or r["written"] != r["ship_pages"] or not ship_ok:
            raise AssertionError(
                f"tp_serve (c) handoff: cluster == unified "
                f"{r['cluster'] == r['unified']}, degrees {r['degrees']}, "
                f"stable {r['cluster_stable']}, rows equal "
                f"{r['rows_equal']}, {r['written']}/{r['ship_pages']} "
                f"pages written, keys equal {r['keys_equal']}, export "
                f"against the one-device export {sr} (limit "
                f"{TP_SHIP_REL}; layer 0 bit for bit unless the witness "
                f"differs)")
    res["handoff"] = {"cluster_launches": [r["cluster_launches"]
                                           for r in hand],
                      "handoff_pages": h0["handoff_pages"],
                      "ship_pages": h0["ship_pages"],
                      "ship_rows": h0["ship_rows"]}
    log(f"tp_serve (c) 1:1 cluster of t={TP_DEGREE} roles, f32 pages: "
        f"{len(greedy)}/{len(greedy)} streams token-identical to the "
        f"t={TP_DEGREE} unified engine ({h0['handoff_pages']} pages handed "
        f"off; kernel 1 launches a rank {res['handoff']['cluster_launches']}"
        f"); a t={TP_DEGREE} export of {h0['ship_pages']} pages imported "
        f"into a one-device engine with equal rows, and against a "
        f"one-device engine's export of the same prompt by layer: "
        f"largest |diff| / max|row| "
        f"{[f'{x:.3g}' for x in h0['ship_rows']['rel']]} (limit "
        f"{TP_SHIP_REL}), bit for bit {h0['ship_rows']['bit_equal']}")
    for kv in one:
        one[kv]["eng"].close()
    del one, lm
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    log(f"tp_serve phase: {res['phase_s']:.1f} s")
    return res


# ------------------------------ the wall-clock pool at t = 2, host weights
POOL_TP_REPLICAS = 2
# about 16 greedy requests arriving over about 0.8 s (the t = 2 steps are
# eager, staged through host memory): requests arrive while others decode
POOL_TP_TRAFFIC = dict(requests=16, seed=5, rate_rps=20.0, tenants=2,
                       prefix_tokens=48, max_prompt=160, max_new_cap=16,
                       sample_frac=0.0)
POOL_TP_CAPPED = 4            # (b): the requests served under the cap


def pool_tp_traffic():
    from flexflow_tpu_torch.serve.traffic import TrafficSpec, make_traffic
    return make_traffic(TrafficSpec(vocab=LM_ARCH["vocab_size"],
                                    **POOL_TP_TRAFFIC))


def pool_tp_host_lm():
    """The README LM at full width on the host, f32, for inference, from
    the port's seeded initializers: tp_lm()'s weights, bit for bit (the
    initializers draw from numpy)."""
    from flexflow_tpu_torch import FFConfig, build_transformer_lm
    from flexflow_tpu_torch.config import CompMode
    m = build_transformer_lm(FFConfig(batch_size=1, seed=0), batch_size=1,
                             device="cpu", **LM_ARCH)
    m.compile(comp_mode=CompMode.INFERENCE)
    return m


def pool_tp_pool(lm, traffic=None):
    """A pool of POOL_TP_REPLICAS t = 2 replicas over ``lm`` on this
    rank's card, eager (gloo stages every collective through host
    memory); serving ``traffic`` on the wall clock when given."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import ReplicaPool
    pool = ReplicaPool(lm, POOL_TP_REPLICAS, config=FFConfig(
        serve_spec_decode=False), device="cuda",
        engine_kwargs=dict(tensor_parallel=TP_DEGREE, capture=False))
    res = None
    if traffic is not None:
        res = pool.run(traffic, sample_seed=0, wall_clock=True)
    return pool, res


def pool_tp_rank_serve():
    """(a) on one gloo rank: the host LM's t = 2 pool booted (the card's
    allocated bytes beside each replica's memory ledger), then the
    stream on the wall clock in lockstep, kernel 1 and the collectives
    counted from 0 just before it."""
    from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr
    from flexflow_tpu_torch.parallel import collectives as C
    lm = pool_tp_host_lm()
    base = torch.cuda.memory_allocated()
    pool, _ = pool_tp_pool(lm)
    torch.cuda.synchronize()
    res = {"allocated_boot": torch.cuda.memory_allocated() - base,
           "ledgers": [r.engine.memory_ledger() for r in pool.replicas],
           "whole_params_bytes": float(sum(
               t.nbytes for p in lm.state.params.values()
               for t in p.values())),
           "degrees": [r.engine.tp for r in pool.replicas],
           "heads_local": pool.replicas[0].engine.cache_cfg
           .heads_per_device}
    traffic = pool_tp_traffic()
    steps0 = sum(r.steps for r in pool.replicas)
    pr.launches = 0
    C.reset_counts()
    st = pool.run(traffic, sample_seed=0, wall_clock=True)
    res["launches"] = pr.launches
    res["collectives"] = dict(C.launches)
    res["steps"] = sum(r.steps for r in pool.replicas) - steps0
    pool.assert_zero_recompiles()
    pool.check_drained()
    res["records"] = [(r["stream_id"], r["replica"], r["outcome"],
                       r["tokens"], r["t_arrival"], r["ttft_s"],
                       r["t_finish"]) for r in st["requests"]]
    res.update({k: st[k] for k in (
        "lockstep", "wall_threads", "lockstep_ticks", "lockstep_calls",
        "lockstep_wall_s", "makespan_s", "goodput_per_s", "completed",
        "tokens_total")})
    pool.close()
    del pool, lm
    gc.collect()
    torch.cuda.empty_cache()
    return res


def pool_tp_rank_capped():
    """(b) on one gloo rank: the host LM's pool boots and serves the
    stream's first POOL_TP_CAPPED requests uncapped, which sets the cap:
    the peak bytes allocated (the larger of the two ranks') plus half
    the whole parameters. Under that cap (``set_per_process_memory_
    fraction``) the same run must pass, and the same pool over the LM
    built on the card must run out of memory while it boots (the model
    alone holds the whole parameters: half more than the cap leaves).
    Both ranks allocate alike, so both fail at the same allocation."""
    import torch.distributed as dist
    traffic = pool_tp_traffic()[:POOL_TP_CAPPED]
    lm = pool_tp_host_lm()
    whole = float(sum(t.nbytes for p in lm.state.params.values()
                      for t in p.values()))

    def host_run():
        pool, st = pool_tp_pool(lm, traffic)
        done = st["completed"]
        pool.close()
        del pool, st
        gc.collect()
        torch.cuda.empty_cache()
        return done

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_reserved()
    res = {"uncapped_completed": host_run()}
    peak = torch.tensor([float(torch.cuda.max_memory_allocated())],
                        dtype=torch.float64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    res["uncapped_peak"] = float(peak.item())
    cap = base + res["uncapped_peak"] + 0.5 * whole
    res["cap_bytes"] = cap
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        torch.cuda.reset_peak_memory_stats()
        res["host_completed"] = host_run()
        res["host_peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res["card_oom"] = None
        try:
            card = tp_lm()
            pool, _ = pool_tp_pool(card)
            pool.close()
            del pool
        except torch.cuda.OutOfMemoryError as e:
            res["card_oom"] = str(e).splitlines()[0][:160]
        res["card_peak"] = torch.cuda.max_memory_allocated()
    finally:
        card = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(1.0)
    return res


def pool_tp_phase(pr, card: str):
    """The wall-clock pool at t = 2 over a model on the host (see the
    module docstring): two gloo ranks sharing the card, each booting a
    pool of two t = 2 replicas from the README LM kept on the host; the
    one-device captured pool of this process over the same weights is
    their reference."""
    import tempfile
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.parallel.launch import RankPool
    from flexflow_tpu_torch.serve import ReplicaPool
    t0 = time.perf_counter()
    res = {"kernel": tp_kernel_check(pr, heads_list=(HEADS // TP_DEGREE,),
                                     pages=("f32",), tag="pool_tp (c)")}
    traffic = pool_tp_traffic()
    lm = tp_lm()
    one = ReplicaPool(lm, POOL_TP_REPLICAS, config=FFConfig(
        serve_spec_decode=False), device="cuda")
    ref = {r["stream_id"]: r["tokens"]
           for r in one.run(traffic, sample_seed=0)["requests"]}
    tmp = Path(tempfile.mkdtemp(prefix="ff_pool_tp_"))
    with RankPool(TP_DEGREE, str(tmp / "init"), backend="gloo",
                  device="cuda", threads=0, timeout_s=600) as ranks:
        rs = ranks.run(pool_tp_rank_serve)
        capped = ranks.run(pool_tp_rank_capped)
    r0 = rs[0]
    whole = r0["whole_params_bytes"]
    L = LM_ARCH["num_layers"]
    bad = []
    if any(r["records"] != r0["records"] for r in rs):
        bad.append("the ranks' records differ")
    if any(r["degrees"] != [TP_DEGREE] * POOL_TP_REPLICAS for r in rs):
        bad.append(f"degrees {[r['degrees'] for r in rs]}")
    if not (r0["lockstep"] and r0["wall_threads"] is False):
        bad.append("not the lockstep loop")
    if r0["completed"] != len(traffic):
        bad.append(f"{r0['completed']}/{len(traffic)} completed")
    for r in rs:
        if r["launches"] != L * r["steps"] or not r["launches"]:
            bad.append(f"kernel 1 launched {r['launches']} times, want "
                       f"{L} layers x {r['steps']} steps")
        for led in r["ledgers"]:
            if led["reference_params_bytes"] != 0.0 \
                    or abs(led["ledger_vs_live"] - 1.0) > LEDGER_REL:
                bad.append(f"ledger {led}")
    by_sid = {t.stream_id: t for t in traffic}
    sids = [rec[0] for rec in r0["records"]]
    eng = one.replicas[0].engine
    exact = eng.assert_token_parity(
        [by_sid[s].prompt for s in sids], [rec[3] for rec in r0["records"]],
        [ref[s] for s in sids], margin=PARITY_MARGIN)
    for r in capped:
        if r["host_completed"] != POOL_TP_CAPPED \
                or r["uncapped_completed"] != POOL_TP_CAPPED:
            bad.append(f"(b) under the cap the host pool completed "
                       f"{r['host_completed']}/{POOL_TP_CAPPED}")
        if r["card_oom"] is None:
            bad.append("(b) the pool over the LM on the card did not run "
                       "out of memory under the cap")
    if bad:
        raise AssertionError(f"pool_tp: {bad}")
    per = [led["params_bytes"] for led in r0["ledgers"]]
    ticks = r0["lockstep_ticks"]
    res.update({
        "exact_streams": exact, "streams": len(sids),
        "launches": [r["launches"] for r in rs],
        "steps": [r["steps"] for r in rs],
        "heads_local": r0["heads_local"],
        "params_bytes_per_engine": per, "whole_params_bytes": whole,
        "params_bytes_before": per[0] + whole,
        "allocated_boot": [r["allocated_boot"] for r in rs],
        "ledger_total_bytes": [sum(led["total_bytes"]
                                   for led in r["ledgers"]) for r in rs],
        "ledger_live_bytes": [sum(led["live_bytes"]
                                  for led in r["ledgers"]) for r in rs],
        "lockstep_ticks": ticks,
        "lockstep_calls_per_tick": r0["lockstep_calls"] / ticks,
        "lockstep_ms_per_call": [1e3 * r["lockstep_wall_s"]
                                 / r["lockstep_calls"] for r in rs],
        "makespan_s": r0["makespan_s"], "goodput_per_s": r0["goodput_per_s"],
        "tokens_total": r0["tokens_total"],
        "collectives_per_step": {k: v / r0["steps"] for k, v in
                                 r0["collectives"].items() if v},
        "capped": capped})
    log(f"pool_tp (a) t={TP_DEGREE} pool of {POOL_TP_REPLICAS} replicas "
        f"over the LM on the host, wall clock in lockstep, two gloo ranks "
        f"sharing the card [{card}]: {exact}/{len(sids)} streams "
        f"token-identical to the one-device captured pool (the rest "
        f"diverge at a tie <= {PARITY_MARGIN}); records equal on both "
        f"ranks; kernel 1 launches a rank {res['launches']} on "
        f"{r0['heads_local']} heads (= {L} layers x steps {res['steps']}); "
        f"lockstep {ticks} ticks, "
        f"{res['lockstep_calls_per_tick']:.2f} calls a tick, "
        f"{[round(x, 4) for x in res['lockstep_ms_per_call']]} ms a call "
        f"(the wait for the other rank included); makespan "
        f"{r0['makespan_s']:.3f} s, goodput {r0['goodput_per_s']:.3f} "
        f"requests/s, {r0['tokens_total']} tokens (two gloo ranks share "
        f"one card and stage through the host: no speed)")
    log(f"pool_tp (b) a rank's parameter bytes an engine "
        f"{[int(x) for x in per]} of {int(whole)} whole (before: the "
        f"shards beside the whole, {int(per[0] + whole)}); the card's "
        f"allocated bytes after boot {res['allocated_boot']} beside the "
        f"ledgers' live {[int(x) for x in res['ledger_live_bytes']]} and "
        f"total {[int(x) for x in res['ledger_total_bytes']]}; the host "
        f"pool's first {POOL_TP_CAPPED} requests uncapped peak at "
        f"{int(capped[0]['uncapped_peak'])} bytes allocated; capped at "
        f"{[int(r['cap_bytes']) for r in capped]} (that peak + half the "
        f"whole parameters): the host pool served "
        f"{[r['host_completed'] for r in capped]} requests, peak "
        f"{[r['host_peak'] for r in capped]}; the pool over the LM on the "
        f"card ran out of memory booting (peak "
        f"{[r['card_peak'] for r in capped]}): "
        f"{[r['card_oom'] for r in capped]}")
    one.close()
    del one, lm, eng
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    log(f"pool_tp phase: {res['phase_s']:.1f} s")
    return res


# ------------------------------ sequence and expert parallelism, placed
# tables: two gloo ranks sharing the card
SP_STEPS = 2
# f32: the one-rank card run's limits (MESH_LOSS_REL, MESH_WEIGHT_ABS):
# a rank's sums of partial gradients over data x seq reduce in another
# order than one device. Under the bf16 policy every activation rounds
# to bf16 (2^-8 relative) and a rank's GEMMs (4096 of the 8192 token
# rows; the ring's f32 hops where one device runs the flash kernels)
# round otherwise than the one-device run's, so a bf16 run is held to
# its losses within SP_BF16_LOSS_REL relative and each weight's update
# within SP_BF16_UPDATE_REL of the one-device run's update of it (L2
# norms): a gradient summed over one rank too few or too many moves an
# update by half or double, far past either limit.
SP_BF16_LOSS_REL = 1e-2
SP_BF16_UPDATE_REL = 0.2
SP_MOE_BATCH = 1024
# a rank's heads in the all-to-all core at seq 2
SP_HEADS = TH // 2


def _host_params(m):
    return {f"{op}.{k}": w.detach().float().cpu().clone()
            for op, p in m.state.params.items() for k, w in p.items()}


def sp_rank_lm(steps):
    """(a) on a gloo rank sharing the card: the dropout LM at full width
    on a (1, 2) data x seq mesh under sequence_parallel_strategy(), in
    f32 and under the bf16 policy, through the all-to-all core (kernels
    2-4 on 4 of 8 heads over the whole sequence) and through the ring,
    eager, against the one-device run of the same weights and keys on
    the same card (each rank runs that reference itself)."""
    import torch.distributed as dist
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.kernels import dropout as kd
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import collectives as C
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.pconfig import \
        sequence_parallel_strategy
    rank = dist.get_rank()
    data = lm_batches(steps)
    mesh = make_mesh((1, 2), ("data", "seq"))

    def build(dtype, mode=None):
        m = dropout_lm_graph(LB, compute_dtype=dtype,
                             mesh=mesh if mode else None,
                             strategy=(sequence_parallel_strategy()
                                       if mode else None), **LM_ARCH)
        if mode:
            m.config.sp_attention = mode
        m.compile(optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
                  loss_type=mesh_lm_loss(), metrics=[], capture=False)
        return m

    seen = {"flash": [], "dropout": []}
    bshd, apply0 = fa.flash_attention_bshd, kd._apply

    def flash_spy(q, k, v, **kw):
        seen["flash"].append(tuple(q.shape))
        return bshd(q, k, v, **kw)

    def drop_spy(x, key, fold, keep, direction, offset=0, rows=None):
        seen["dropout"].append((tuple(x.shape), int(offset), rows))
        return apply0(x, key, fold, keep, direction, offset, rows)

    out = {"rank": rank}
    for dtype in ("float32", "bfloat16"):
        ref = build(dtype)
        init = _host_params(ref)
        ref_losses = [float(ref.train_batch(b)["loss"]) for b in data]
        ref_w = _host_params(ref)
        release(ref)
        del ref
        top_update = max(float((ref_w[n] - init[n]).abs().max())
                         for n in init)
        for mode in ("alltoall", "ring"):
            m = build(dtype, mode)
            fl0, dr0 = dict(fa.launches), dict(kd.launches)
            seen["flash"].clear()
            seen["dropout"].clear()
            fa.flash_attention_bshd, kd._apply = flash_spy, drop_spy
            C.reset_counts()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = [float(m.train_batch(b)["loss"]) for b in data]
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3 / steps
            finally:
                fa.flash_attention_bshd, kd._apply = bshd, apply0
            coll = {k: v / steps for k, v in C.launches.items() if v}
            staged = sum(C.staged_bytes.values()) / steps / 2**20
            glob = _host_params(m)
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                            ref_losses))
            wdiff = max(float((glob[n] - ref_w[n]).abs().max())
                        for n in ref_w)
            # each weight's update against the one-device run's, relative
            # to that update (L2 norms; weights the steps left unmoved
            # skipped)
            upd = max(float((glob[n] - ref_w[n]).norm()
                            / (ref_w[n] - init[n]).norm())
                      for n in ref_w if float((ref_w[n] - init[n]).norm()))
            if dtype == "float32":
                lim = (MESH_LOSS_REL, MESH_WEIGHT_ABS)
                got = wdiff
            else:
                lim = (SP_BF16_LOSS_REL, SP_BF16_UPDATE_REL)
                got = upd
            flash = {k: fa.launches[k] - fl0.get(k, 0)
                     for k in ("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv")}
            drop = {k: kd.launches[k] - dr0[k] for k in kd.launches}
            cell = {"losses": losses, "ref_losses": ref_losses,
                    "max_loss_rel": rel, "max_weight_abs": wdiff,
                    "max_update_rel": upd,
                    "limits": lim, "largest_update": top_update,
                    "flash_launches": flash, "dropout_launches": drop,
                    "flash_shape": seen["flash"][0] if seen["flash"]
                    else None,
                    "dropout_blocks": seen["dropout"][:2],
                    "collectives_per_step": coll,
                    "staged_mib_per_step": staged, "step_ms": step_ms}
            out[f"{dtype} {mode}"] = cell
            release(m)
            del m
            if not (rel <= lim[0] and got <= lim[1]):
                raise AssertionError(
                    f"sp (a) {dtype} {mode} rank {rank}: against the "
                    f"one-device run loss rel {rel} (limit {lim[0]}), "
                    f"weights abs {wdiff}, updates rel {upd} (limit "
                    f"{lim[1]})")
            layers = LM_ARCH["num_layers"]
            want = layers * steps if mode == "alltoall" else 0
            if any(v != want for v in flash.values()):
                raise AssertionError(f"sp (a) {dtype} {mode}: flash "
                                     f"launches {flash}, want {want} each")
            if mode == "alltoall" and cell["flash_shape"] != (
                    LB, TS, SP_HEADS, TD):
                raise AssertionError(f"sp (a): the all-to-all core ran on "
                                     f"{cell['flash_shape']}")
            if any(v != 2 * layers * steps for v in drop.values()):
                raise AssertionError(f"sp (a) {dtype} {mode}: dropout "
                                     f"launches {drop}")
    return out


def sp_rank_moe(steps):
    """(c) build_moe_fused at batch SP_MOE_BATCH (8 experts, top-2) on a
    (1, 2) data x expert mesh under JAX's expert_parallel strategy
    ({"sample": "data", "expert": "expert"}): each rank holds 4
    experts; against the one-device run on the card at f32 limits."""
    import torch.distributed as dist
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel import collectives as C
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.pconfig import OpStrategy, Strategy
    rank = dist.get_rank()
    host = moe_batches(SP_MOE_BATCH, steps, seed=4)

    def build(mesh=None, st=None):
        m = ft.build_moe_fused(ft.FFConfig(batch_size=SP_MOE_BATCH, seed=0),
                               batch_size=SP_MOE_BATCH, device="cuda",
                               mesh=mesh, strategy=st)
        m.compile(optimizer=ft.SGDOptimizer(lr=0.01),
                  loss_type="sparse_categorical_crossentropy", metrics=[],
                  capture=False)
        return m

    ref = build()
    ref_losses = [float(ref.train_batch(b)["loss"]) for b in host]
    ref_w = _host_params(ref)
    del ref
    m = build(make_mesh((1, 2), ("data", "expert")),
              Strategy(default=OpStrategy({"sample": "data",
                                           "expert": "expert"})))
    local = tuple(m.state.params["moe"]["w1"].shape)
    C.reset_counts()
    losses = [float(m.train_batch(b)["loss"]) for b in host]
    coll = {k: v / steps for k, v in C.launches.items() if v}
    glob = {f"{op}.{k}": torch.from_numpy(v)
            for op in m.state.params
            for k, v in m.get_weights(op).items()}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    wdiff = max(float((glob[n] - ref_w[n]).abs().max()) for n in ref_w)
    if not (rel <= MESH_LOSS_REL and wdiff <= MESH_WEIGHT_ABS) \
            or local[0] * 2 != next(o for o in m.ops
                                    if o.op_type == "moe_ffn").num_experts:
        raise AssertionError(f"sp (c) rank {rank}: loss rel {rel}, weights "
                             f"{wdiff}, local w1 {local}")
    return {"rank": rank, "local_w1": local, "losses": losses,
            "ref_losses": ref_losses, "max_loss_rel": rel,
            "max_weight_abs": wdiff, "collectives_per_step": coll}


def sp_rank_dlrm(steps):
    """(d) DLRM "full", stacked (26 tables of 1M x 64), on a (2,) data
    mesh with the tables placed round-robin over the two ranks
    (placement_assignment, the DLRM generator's scheme), sparse SGD
    updates through sparse_rows.cu on each rank's slots; against the
    one-device step on the card from the same weights (the reference's
    tables permuted to the slot layout's draw), each rank checking its
    own slots."""
    import torch.distributed as dist
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import sparse_rows as sr
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.pconfig import (DEVICE_KEY, OpStrategy,
                                                     Strategy,
                                                     placement_assignment)
    rank = dist.get_rank()
    f = DLRM_FULL
    ids = placement_assignment(f["tables"], 2, "round_robin")
    st = Strategy(default=OpStrategy({"sample": "data"}))
    st.set("emb_tables", OpStrategy({DEVICE_KEY: ids}))
    host = dlrm_batches(f["tables"], f["vocab"], f["batch"], steps, seed=2)
    t0 = time.perf_counter()
    m = ft.build_dlrm(ft.FFConfig(batch_size=f["batch"], seed=0,
                                  sparse_embedding_updates=True),
                      batch_size=f["batch"], embedding_vocab_sizes=(
                          f["vocab"],) * f["tables"], embedding_dim=DLRM_DIM,
                      stacked_tables=True, device="cuda",
                      mesh=make_mesh((2,), ("data",)), strategy=st)
    m.compile(optimizer=ft.SGDOptimizer(lr=0.01),
              loss_type="mean_squared_error", metrics=[], capture=False)
    init_s = time.perf_counter() - t0
    op = next(o for o in m.ops if o.op_type == "distributed_embedding")
    k = op.num_slots // 2
    mine = list(op._slots[rank * k:(rank + 1) * k])
    if sorted(mine) != [t for t in range(f["tables"]) if ids[t] == rank] \
            or tuple(m.state.params["emb_tables"]["kernel"].shape) != (
                k, f["vocab"], DLRM_DIM):
        raise AssertionError(f"sp (d) rank {rank}: slots {mine} for "
                             f"placement {ids}")
    sr.launches.update(dict.fromkeys(sr.launches, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(m.train_batch(b)["loss"]) for b in host]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = dict(sr.launches)
    ref = dlrm_model(stacked=True, capture=False, **f)
    with torch.no_grad():
        # the slot layout drew table t's rows where the one-device run
        # drew slot t's: permute the reference to the same tables
        kern = ref.state.params["emb_tables"]["kernel"]
        kern.copy_(kern[list(op._slot_of_table)])
    ref_losses = [float(ref.train_batch(b)["loss"]) for b in host]
    with torch.no_grad():
        rk = ref.state.params["emb_tables"]["kernel"]
        tdiff = max(float((m.state.params["emb_tables"]["kernel"][j]
                           - rk[t]).abs().max())
                    for j, t in enumerate(mine))
        ddiff = max(float((w - ref.state.params[o][n]).abs().max())
                    for o, p in m.state.params.items() if o != "emb_tables"
                    for n, w in p.items())
    del ref
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    if not (rel <= MESH_LOSS_REL and max(tdiff, ddiff) <= MESH_WEIGHT_ABS):
        raise AssertionError(f"sp (d) rank {rank}: loss rel {rel}, slots "
                             f"{tdiff}, dense {ddiff}")
    if launches != {"sparse_rows_exact": steps, "sparse_rows_lazy": 0}:
        raise AssertionError(f"sp (d) rank {rank}: sparse_rows launches "
                             f"{launches}, want {steps} exact")
    return {"rank": rank, "slots": mine, "losses": losses,
            "ref_losses": ref_losses, "max_loss_rel": rel,
            "max_slot_abs": tdiff, "max_dense_abs": ddiff,
            "sparse_rows_launches": launches, "step_ms": step_ms,
            "init_s": init_s}


def sp_rank_nccl():
    """The NCCL branches on one NCCL rank, at axis size 1: the
    all-to-all core through NCCL's all_to_all_single against the flash
    kernels alone, and a ring of one rank (no hop)."""
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import collectives as C
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.ring_attention import ring_attention
    from flexflow_tpu_torch.parallel.ulysses import alltoall_attention
    bm = make_mesh((1, 1), ("data", "seq")).bind()
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 256, SP_HEADS, TD), np.float32)).cuda().bfloat16()
        for _ in range(3))
    C.reset_counts()
    a2a = alltoall_attention(q, k, v, bm, causal=True)
    ring = ring_attention(q, k, v, bm, causal=True)
    whole = fa.flash_attention_bshd(q, k, v, causal=True)
    torch.cuda.synchronize()
    err_a2a = float((a2a.float() - whole.float()).abs().max())
    err_ring = float((ring.float() - whole.float()).abs().max()
                     / whole.float().abs().max())
    if err_a2a != 0.0 or err_ring > FLASH_TOL[torch.bfloat16] \
            or C.launches["all_to_all"] != 4 or C.launches["ppermute"]:
        raise AssertionError(f"sp (e) NCCL at axis size 1: all-to-all "
                             f"core {err_a2a}, ring {err_ring}, launches "
                             f"{dict(C.launches)}")
    return {"backend": bm.backend, "alltoall_vs_flash_abs": err_a2a,
            "ring_vs_flash_rel": err_ring,
            "all_to_all_launches": C.launches["all_to_all"]}


def ulysses_kernel_check(fa, heads=SP_HEADS, tag="ulysses",
                         phase="sp (b)"):
    """(b) kernels 2-4 at the all-to-all core's per-rank shape of the
    README LM at seq 2 (b=16, s=512, 4 heads, d=64, causal; ``heads``
    for another axis size), f32 and bf16: each against its plain piece
    (FLASH_TOL), timed beside its bound and
    scaled_dot_product_attention in 3 interleaved rounds."""
    dev = torch.device("cuda")
    scale = 1.0 / math.sqrt(TD)
    res = {}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        rng = np.random.default_rng(13)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (LB, TS, heads, TD), np.float32)).to(dev).to(dtype)
            for _ in range(4))
        kw = {"causal": True, "scale": scale}
        errs, bargs = flash_errors(fa, q, k, v, do, kw)
        plain = {
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd_ref(q, k, v, **kw), 3),
            "flash_bwd_dq": cuda_ms(
                lambda: fa.flash_bwd_dq_ref(*bargs, **kw), 3),
            "flash_bwd_dkv": cuda_ms(
                lambda: fa.flash_bwd_dkv_ref(*bargs, **kw), 3)}
        lib_fwd, lib_bwd = sdpa_fns(q, k, v, do, True)
        rounds = yardstick({
            "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, **kw),
            "sdpa_fwd": lib_fwd,
            "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(*bargs, **kw),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(*bargs, **kw),
            "sdpa_bwd": lib_bwd})
        bounds = flash_bounds(dtype, True, LB, heads)
        for kname in plain:
            b_ms, b_by = bounds[kname]
            lib = "sdpa_fwd" if kname == "flash_fwd" else "sdpa_bwd"
            res.setdefault(kname, {})[f"{tag}_{dname}_causal"] = {
                "shape": f"b={LB} s={TS} h={heads} d={TD}",
                "max_abs_err": errs[kname][0],
                "err_over_max_ref": errs[kname][1],
                "ms": statistics.median(rounds[kname]),
                "plain_ms": plain[kname], "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": statistics.median(rounds[lib]),
                "ms_rounds": rounds[kname], "library_ms_rounds": rounds[lib]}
            log(f"{phase} kernel {kname} [{tag} {dname} causal, b={LB} "
                f"s={TS} h={heads} d={TD}]: max_abs_err="
                f"{errs[kname][0]:.3g} err/max|ref|={errs[kname][1]:.3g} "
                f"kernel_ms={spread(rounds[kname])} plain_ms="
                f"{plain[kname]:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                f"library_ms={spread(rounds[lib])}")
        del q, k, v, do, bargs, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    return res


def sp_phase(fa, card: str):
    """Sequence parallelism, expert parallelism and placed tables on two
    gloo ranks sharing the card (eager: every collective staged through
    pinned host memory; NCCL refuses two ranks on one card), spawned as
    ``mesh_phase`` (b) spawns them: (a) the README LM, (c) the MoE, (d)
    DLRM "full" placed; then (b) kernels 2-4 at the all-to-all core's
    per-rank shape in this process and (e) the NCCL branches on one
    NCCL rank at axis size 1."""
    import tempfile
    from flexflow_tpu_torch.parallel.launch import RankPool
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="ff_sp_"))
    res = {}
    with RankPool(2, str(tmp / "g"), backend="gloo", device="cuda",
                  threads=0, timeout_s=900) as pool:
        ra = pool.run(sp_rank_lm, SP_STEPS)
        rc = pool.run(sp_rank_moe, SP_STEPS)
        rd = pool.run(sp_rank_dlrm, SP_STEPS)
    res["lm"], res["moe"], res["dlrm"] = ra, rc, rd
    for key in ("float32 alltoall", "float32 ring", "bfloat16 alltoall",
                "bfloat16 ring"):
        c = [r[key] for r in ra]
        log(f"sp (a) LM {key} on (1, 2) data x seq, two gloo ranks on one "
            f"card ({card}): vs the one-device run loss rel "
            f"{max(x['max_loss_rel'] for x in c):.3e}, weights abs "
            f"{max(x['max_weight_abs'] for x in c):.3e}, updates rel "
            f"{max(x['max_update_rel'] for x in c):.3e} (limits "
            f"{c[0]['limits'][0]:.3g}, {c[0]['limits'][1]:.3g}; largest "
            f"update {c[0]['largest_update']:.3e}); flash launches a rank "
            f"{[x['flash_launches'] for x in c]} on "
            f"{c[0]['flash_shape']}; dropout {[x['dropout_launches'] for x in c]}"
            f", first blocks (shape, offset, rows) "
            f"{[x['dropout_blocks'] for x in c]}; collectives a step "
            f"{c[0]['collectives_per_step']}; staged "
            f"{[round(x['staged_mib_per_step'], 2) for x in c]} MiB a "
            f"step; eager step {[round(x['step_ms'], 1) for x in c]} ms")
    log(f"sp (c) MoE fused b={SP_MOE_BATCH} on (1, 2) data x expert: local "
        f"w1 {rc[0]['local_w1']}; loss rel "
        f"{max(r['max_loss_rel'] for r in rc):.3e}, weights abs "
        f"{max(r['max_weight_abs'] for r in rc):.3e}; collectives a step "
        f"{rc[0]['collectives_per_step']}")
    log(f"sp (d) DLRM full stacked, round-robin placement on (2,) data: "
        f"slots {[r['slots'] for r in rd]}; loss rel "
        f"{max(r['max_loss_rel'] for r in rd):.3e}, slots abs "
        f"{max(r['max_slot_abs'] for r in rd):.3e}, dense abs "
        f"{max(r['max_dense_abs'] for r in rd):.3e}; sparse_rows a rank "
        f"{[r['sparse_rows_launches'] for r in rd]}; eager step "
        f"{[round(r['step_ms'], 1) for r in rd]} ms; init "
        f"{[round(r['init_s'], 1) for r in rd]} s")
    res["kernels"] = ulysses_kernel_check(fa)
    with RankPool(1, str(tmp / "n"), backend="nccl", device="cuda",
                  threads=0, timeout_s=300) as pool:
        res["nccl"] = pool.run(sp_rank_nccl)[0]
    log(f"sp (e) NCCL at axis size 1: {res['nccl']}")
    res["phase_s"] = time.perf_counter() - t0
    log(f"sp phase: {res['phase_s']:.1f} s")
    return res


# ----------------------------------- pipelines: two gloo ranks on the card
PP_STEPS = 2
PP_MICRO = 4
# (d) the microbatch of the LM at M = PP_MICRO: b = LB / M
PP_MB = LB // PP_MICRO
# The bf16 policy's limits, set from readings on an H100 (80GB HBM3,
# 700 W): a sound pipelined run reads a loss 2.3e-6 relative and
# updates 6.3e-2 relative of the one-device run's (f32 reads 2.45e-2:
# two SGD steps move a weight by a few ulps, so the update's rounding
# dominates); a last stage that took its loss on bf16 logits read
# 1.39e-3 on the loss. A gradient summed once too often, or without
# its 1/M, moves an update by 1 or M - 1 relative.
PP_BF16_LOSS_REL = 1e-4
PP_BF16_UPDATE_REL = 0.1


def _pp_cut(m):
    """{stage: [op names]} of a pipelined model's plan."""
    plan = m.executor.plan
    return {s: [op.name for op in ops] for s, ops in enumerate(plan.stages)}


def _pp_run(dtype, data, mesh=None, strategy=None, build=None, **cfg):
    """Train ``data`` on a model (the LM at full width unless ``build``)
    eagerly; returns the losses, the global weights (host, f32; every
    rank gathers them from their owners), the flash launches, the
    point-to-point and collective launches a step, the MiB staged a
    step, the step time and, on a pipeline, the cut, the rank's
    attention ops, its resident bytes beside its PackSpec rows and its
    in-flight peaks."""
    from flexflow_tpu_torch.core.staged import StagedExecutor
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import collectives as C
    m = (build or lm_model)(dtype, capture=False, mesh=mesh,
                            strategy=strategy, **cfg)
    ex = m.executor
    staged = isinstance(ex, StagedExecutor)
    fl0 = {k: fa.launches[k] for k in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    C.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(m.train_batch(b)["loss"]) for b in data]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / len(data)
    out = {"losses": losses, "step_ms": step_ms,
           "flash_launches": {k: fa.launches[k] - v
                              for k, v in fl0.items()},
           "p2p_per_step": {k: v / len(data) for k, v in C.launches.items()
                            if v},
           "staged_mib_per_step": sum(C.staged_bytes.values())
           / len(data) / 2 ** 20}
    if staged:
        own = [op.name for s in ex._own_stages for op in ex.plan.stages[s]]
        out.update(cut=_pp_cut(m), stages=list(ex._own_stages),
                   attn_ops=[n for n in own
                             if n.endswith("_attn") or n == "pipeline"],
                   resident=ex.resident_bytes(m.state),
                   peak=dict(ex.last_peak))
    out["weights"] = {op.name: {k: torch.from_numpy(v)
                                for k, v in m.get_weights(op.name).items()}
                      for op in m.ops if op.weight_specs()}
    release(m)
    del m
    return out


def _pp_compare(got, ref, init, dtype):
    """(loss rel, weight abs, update rel, limits, ok) of a run against
    the one-device one: f32 at MESH_LOSS_REL / MESH_WEIGHT_ABS, bf16 at
    PP_BF16_LOSS_REL / PP_BF16_UPDATE_REL (each weight's update against
    the one-device update of it, L2 norms)."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                  ref["losses"]))
    pairs = [(got["weights"][op][k], w, init[op][k])
             for op, ws in ref["weights"].items() for k, w in ws.items()]
    wabs = max(float((a - b).abs().max()) for a, b, _ in pairs)
    upd = max(float((a - b).norm() / (b - i).norm())
              for a, b, i in pairs if float((b - i).norm()))
    if dtype == "float32":
        lim, worst = (MESH_LOSS_REL, MESH_WEIGHT_ABS), wabs
    else:
        lim, worst = (PP_BF16_LOSS_REL, PP_BF16_UPDATE_REL), upd
    return rel, wabs, upd, lim, rel <= lim[0] and worst <= lim[1]


def pp_rank_lm(steps):
    """(a)-(c) on a gloo rank sharing the card: the README LM at full
    width auto-cut over a (2,) pipe mesh, M = PP_MICRO, under GPipe and
    1F1B, f32 and the bf16 policy, and interleaved (v = 2: 4 stages on
    2 ranks) under 1F1B in f32, each against the one-device run of the
    same weights on the card (each rank runs it); the rank's flash
    launches, transfers, staged MiB and resident bytes."""
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    rank = dist.get_rank()
    data = lm_batches(steps)
    mesh = make_mesh((2,), ("pipe",))
    out = {"rank": rank}
    refs, inits = {}, {}
    for dtype in ("float32", "bfloat16"):
        m = lm_model(dtype, capture=False)
        inits[dtype] = {op: {k: w.detach().float().cpu().clone()
                             for k, w in ws.items()}
                        for op, ws in m.state.params.items()}
        release(m)
        del m
        refs[dtype] = _pp_run(dtype, data)
    cases = [(d, s, 1) for d in ("float32", "bfloat16")
             for s in ("gpipe", "1f1b")] + [("float32", "1f1b", 2)]
    for dtype, sched, v in cases:
        got = _pp_run(dtype, data, mesh, pipeline_stages=2,
                      pipeline_schedule=sched,
                      pipeline_microbatches=PP_MICRO,
                      pipeline_virtual_stages=v)
        rel, wabs, upd, lim, ok = _pp_compare(got, refs[dtype],
                                              inits[dtype], dtype)
        layers = len(got["attn_ops"])
        want = layers * PP_MICRO * steps
        res = got["resident"]
        cell = {k: got[k] for k in ("losses", "flash_launches",
                                    "p2p_per_step", "staged_mib_per_step",
                                    "step_ms", "cut", "stages", "attn_ops",
                                    "resident", "peak")}
        cell.update(ref_losses=refs[dtype]["losses"],
                    ref_step_ms=refs[dtype]["step_ms"],
                    max_loss_rel=rel, max_weight_abs=wabs,
                    max_update_rel=upd, limits=lim)
        key = f"{dtype} {sched}" + (f" v={v}" if v > 1 else "")
        out[key] = cell
        if not ok:
            raise AssertionError(
                f"pp (a) {key} rank {rank}: against the one-device run "
                f"loss rel {rel} (limit {lim[0]}), weights abs {wabs}, "
                f"updates rel {upd} (limit {lim[1]})")
        if any(n != want for n in got["flash_launches"].values()):
            raise AssertionError(
                f"pp (c) {key} rank {rank}: flash launches "
                f"{got['flash_launches']}, want {want} each ({layers} "
                f"attention layers x {PP_MICRO} microbatches x {steps})")
        if res["params"] != res["pack_params"] or any(
                s != res["pack_slot"] for s in res["slots"].values()):
            raise AssertionError(f"pp (c) {key} rank {rank}: resident "
                                 f"bytes {res} are not its PackSpec rows")
    return out


def _pp_blocks_model(dtype, capture=False, mesh=None, strategy=None,
                     **cfg):
    """The LM at full width with its 6 blocks as one ``pipeline_blocks``
    op (M = PP_MICRO): the embeddings, the stack, the final norm and the
    head."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    a = LM_ARCH

    def block(sub, t):
        x = sub.layer_norm(t, name="ln1")
        x = sub.multihead_attention(x, x, x, a["hidden"], a["num_heads"],
                                    causal=True, name="attn")
        t = sub.add(x, t, name="res1")
        x = sub.layer_norm(t, name="ln2")
        x = sub.dense(sub.dense(x, a["ff_dim"], activation="relu",
                                name="ff1"), a["hidden"], name="ff2")
        return sub.add(x, t, name="res2")

    m = FFModel(FFConfig(batch_size=LB, seed=0, compute_dtype=dtype, **cfg),
                mesh=mesh, strategy=strategy, device="cuda")
    tok = m.create_tensor((LB, TS), dtype=torch.int32, name="tokens")
    pos = m.create_tensor((LB, TS), dtype=torch.int32, name="positions")
    t = m.add(m.embedding(tok, a["vocab_size"], a["hidden"], aggr="none",
                          name="tok_embed"),
              m.embedding(pos, a["max_seq_len"], a["hidden"], aggr="none",
                          name="pos_embed"), name="embed_add")
    t = m.pipeline_blocks(t, block, a["num_layers"],
                          num_microbatches=PP_MICRO, name="pipeline")
    m.dense(m.layer_norm(t, name="final_ln"), a["vocab_size"],
            name="lm_head")
    m.compile(optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
              loss_type=mesh_lm_loss(), metrics=[], capture=capture)
    return m


def pp_rank_blocks(steps):
    """(e) on a gloo rank: the LM's block stacked 6 deep as
    ``pipeline_blocks`` with ``layer -> pipe`` on a (2,) pipe mesh (3
    layers a rank, GPipe over the axis, M = PP_MICRO) against its
    one-device loop, f32, from the same weights."""
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.pconfig import OpStrategy, Strategy
    data = lm_batches(steps)
    m = _pp_blocks_model("float32")
    init = {op: {k: w.detach().float().cpu().clone() for k, w in ws.items()}
            for op, ws in m.state.params.items()}
    release(m)
    del m
    ref = _pp_run("float32", data, build=_pp_blocks_model)
    got = _pp_run("float32", data, make_mesh((2,), ("pipe",)),
                  Strategy(default=OpStrategy({"layer": "pipe"})),
                  build=_pp_blocks_model)
    rel, wabs, upd, lim, ok = _pp_compare(got, ref, init, "float32")
    want = LM_ARCH["num_layers"] // 2 * PP_MICRO * steps
    out = {"rank": dist.get_rank(), "losses": got["losses"],
           "ref_losses": ref["losses"], "max_loss_rel": rel,
           "max_weight_abs": wabs, "limits": lim,
           "flash_launches": got["flash_launches"],
           "ref_flash_launches": ref["flash_launches"],
           "p2p_per_step": got["p2p_per_step"],
           "staged_mib_per_step": got["staged_mib_per_step"],
           "step_ms": got["step_ms"], "ref_step_ms": ref["step_ms"]}
    if not ok or any(n != want for n in got["flash_launches"].values()):
        raise AssertionError(f"pp (e) rank {out['rank']}: {out}")
    return out


def pp_kernel_check(fa):
    """(d) kernels 2-4 at the pipelined LM's microbatch shape (b =
    PP_MB, s = 512, 8 heads, d = 64, causal), f32 and bf16: each against
    its plain piece (FLASH_TOL), timed beside its bound and
    scaled_dot_product_attention in 3 interleaved rounds."""
    dev = torch.device("cuda")
    scale = 1.0 / math.sqrt(TD)
    res = {}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        rng = np.random.default_rng(17)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (PP_MB, TS, TH, TD), np.float32)).to(dev).to(dtype)
            for _ in range(4))
        kw = {"causal": True, "scale": scale}
        errs, bargs = flash_errors(fa, q, k, v, do, kw)
        plain = {
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd_ref(q, k, v, **kw), 3),
            "flash_bwd_dq": cuda_ms(
                lambda: fa.flash_bwd_dq_ref(*bargs, **kw), 3),
            "flash_bwd_dkv": cuda_ms(
                lambda: fa.flash_bwd_dkv_ref(*bargs, **kw), 3)}
        lib_fwd, lib_bwd = sdpa_fns(q, k, v, do, True)
        rounds = yardstick({
            "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, **kw),
            "sdpa_fwd": lib_fwd,
            "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(*bargs, **kw),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(*bargs, **kw),
            "sdpa_bwd": lib_bwd})
        bounds = flash_bounds(dtype, True, PP_MB, TH)
        for kname in plain:
            b_ms, b_by = bounds[kname]
            lib = "sdpa_fwd" if kname == "flash_fwd" else "sdpa_bwd"
            res.setdefault(kname, {})[f"pp_{dname}_causal"] = {
                "shape": f"b={PP_MB} s={TS} h={TH} d={TD}",
                "max_abs_err": errs[kname][0],
                "err_over_max_ref": errs[kname][1],
                "ms": statistics.median(rounds[kname]),
                "plain_ms": plain[kname], "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": statistics.median(rounds[lib]),
                "ms_rounds": rounds[kname], "library_ms_rounds": rounds[lib]}
            log(f"pp (d) kernel {kname} [microbatch {dname} causal, "
                f"b={PP_MB} s={TS} h={TH} d={TD}]: max_abs_err="
                f"{errs[kname][0]:.3g} err/max|ref|={errs[kname][1]:.3g} "
                f"kernel_ms={spread(rounds[kname])} plain_ms="
                f"{plain[kname]:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                f"library_ms={spread(rounds[lib])}")
        del q, k, v, do, bargs, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    return res


def pp_phase(fa, card: str):
    """Pipelines on two gloo ranks sharing the card (eager: every
    transfer staged through pinned host memory; NCCL refuses two ranks
    on one card), spawned as ``sp_phase`` spawns them: (a)-(c) the
    README LM auto-cut over pipe = 2, (e) its blocks stacked as
    ``pipeline_blocks``; then (d) kernels 2-4 at the microbatch shape
    in this process."""
    import tempfile
    from flexflow_tpu_torch.parallel.launch import RankPool
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="ff_pp_"))
    res = {}
    with RankPool(2, str(tmp / "g"), backend="gloo", device="cuda",
                  threads=0, timeout_s=900) as pool:
        ra = pool.run(pp_rank_lm, PP_STEPS)
        re_ = pool.run(pp_rank_blocks, PP_STEPS)
    res["lm"], res["blocks"] = ra, re_
    log(f"pp (a) the cut of the LM at pipe = 2: "
        f"{ra[0]['float32 gpipe']['cut']}")
    log(f"pp (a) the cut at v = 2 (stage s on rank s mod 2): "
        f"{ra[0]['float32 1f1b v=2']['cut']}")
    for key in ("float32 gpipe", "float32 1f1b", "bfloat16 gpipe",
                "bfloat16 1f1b", "float32 1f1b v=2"):
        c = [r[key] for r in ra]
        log(f"pp (a) LM {key} M={PP_MICRO} on (2,) pipe, two gloo ranks "
            f"on one card ({card}): vs the one-device run loss rel "
            f"{max(x['max_loss_rel'] for x in c):.3e}, weights abs "
            f"{max(x['max_weight_abs'] for x in c):.3e}, updates rel "
            f"{max(x['max_update_rel'] for x in c):.3e} (limits "
            f"{c[0]['limits'][0]:.3g}, {c[0]['limits'][1]:.3g})")
        log(f"pp (c) {key}: a rank's stages {[x['stages'] for x in c]}, "
            f"attention ops {[x['attn_ops'] for x in c]}, flash launches "
            f"{[x['flash_launches'] for x in c]}; transfers and "
            f"collectives a step {[x['p2p_per_step'] for x in c]}; staged "
            f"{[round(x['staged_mib_per_step'], 2) for x in c]} MiB a "
            f"step; resident {[x['resident'] for x in c]}; in-flight "
            f"peaks {[x['peak'] for x in c]}; eager step "
            f"{[round(x['step_ms'], 1) for x in c]} ms (one device "
            f"{[round(x['ref_step_ms'], 1) for x in c]} ms)")
    log(f"pp (e) pipeline_blocks LM stack (layer -> pipe, 3 layers a rank)"
        f": vs the one-device loop loss rel "
        f"{max(r['max_loss_rel'] for r in re_):.3e}, weights abs "
        f"{max(r['max_weight_abs'] for r in re_):.3e}; flash launches "
        f"{[r['flash_launches'] for r in re_]} (one device "
        f"{re_[0]['ref_flash_launches']}); transfers a step "
        f"{[r['p2p_per_step'] for r in re_]}; staged "
        f"{[round(r['staged_mib_per_step'], 2) for r in re_]} MiB a step;"
        f" eager step {[round(r['step_ms'], 1) for r in re_]} ms (one "
        f"device {round(re_[0]['ref_step_ms'], 1)} ms)")
    res["kernels"] = pp_kernel_check(fa)
    res["phase_s"] = time.perf_counter() - t0
    log(f"pp phase: {res['phase_s']:.1f} s")
    return res


# ------------------------------------------- channel_out on conv and LSTM
CH_STEPS = 2
CH_NCCL_STEPS = 3
# kernels 7-8 in the split form at a rank's shape on a model axis of two:
# the NMT's T and B, Hin = NH (the gathered h), Hu = NH / 2
CH_RANKS = 2
CH_HU = NH // CH_RANKS


def ch_strategy(ops):
    """``sample -> data`` on every op, and ``channel_out -> model`` on
    ``ops``: the search's winner's form on the NMT's LSTMs and
    AlexNet's convs."""
    from flexflow_tpu_torch.parallel.pconfig import OpStrategy, Strategy
    st = Strategy(default=OpStrategy({"sample": "data"}))
    for name in ops:
        st.set(name, OpStrategy({"sample": "data", "channel_out": "model"}))
    return st


def ch_nmt(dtype, mesh=None, strategy=None, capture=False):
    """build_nmt_lstm at full width (nmt_graph's), SGD lr 0.01."""
    from flexflow_tpu_torch import FFConfig, SGDOptimizer, build_nmt_lstm
    m = build_nmt_lstm(FFConfig(batch_size=NB, seed=0), batch_size=NB,
                       seq_len=NT, vocab_size=NV, embed_dim=NH, hidden=NH,
                       num_layers=NL, dtype=dtype, device="cuda", mesh=mesh,
                       strategy=strategy)
    m.compile(optimizer=SGDOptimizer(lr=0.01),
              loss_type="sparse_categorical_crossentropy", metrics=[],
              capture=capture)
    return m


def ch_blocks(m, tree):
    """This rank's blocks of a global {op.weight: tensor} tree, in the
    layouts the mesh model ``m`` stores them (a sparse table's row
    gradient, ``__rows__``, is the global batch's on every rank)."""
    from flexflow_tpu_torch.parallel.sharding import shard
    ex = m.executor
    out = {}
    for n, w in tree.items():
        op, k = n.split(".")
        out[n] = shard(w, ex._wstore[op][k], ex.bm) \
            if k in ex._wstore[op] else w
    return out


def ch_compare(m, losses, ref_losses, grads=None, ref_grads=None):
    """Loss rel, the weights' largest absolute difference and each
    weight's gradient error (relative L2 over the steps, grad_errs) of a
    mesh model's rank against the one-rank run's blocks."""
    out = {"loss_rel": max(abs(a - b) / abs(b)
                           for a, b in zip(losses, ref_losses))}
    if grads is not None:
        errs = grad_errs([{n: g for n, g in s.items()} for s in grads],
                         [ch_blocks(m, s) for s in ref_grads])
        worst = max(errs, key=errs.get)
        out["grad_rel"] = {n: e for n, e in errs.items() if "lstm" in n}
        out["worst_grad"] = (worst, errs[worst])
    return out


def channel_rank_nmt(steps):
    """(a) on two gloo ranks of one card, eager: the NMT at full width on
    a (1, 2) data x model mesh with channel_out on both LSTMs, f32 and
    bf16, ``steps`` SGD steps, against the one-rank card run of the same
    weights and batches (each rank trains it too: it holds the blocks of
    every gradient and weight it is compared with)."""
    import torch.distributed as dist
    from flexflow_tpu_torch.kernels import lstm_scan as ls
    from flexflow_tpu_torch.parallel import collectives as C
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    batches = nmt_batches(steps)
    mesh = make_mesh((1, CH_RANKS), ("data", "model"))
    strat = ch_strategy([f"lstm_{i}" for i in range(NL)])
    out = {"rank": dist.get_rank()}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ref = ch_nmt(dtype)
        ref_losses, ref_grads = record_steps(ref, batches, steps)
        ref_w = weights_of(ref)
        release(ref)
        del ref
        dist.barrier()
        m = ch_nmt(dtype, mesh, strat)
        for counts in (ls.launches, ls.device_launches):
            counts.update(dict.fromkeys(counts, 0))
        C.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, grads = record_steps(m, batches, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cell = ch_compare(m, losses, ref_losses, grads, ref_grads)
        del grads, ref_grads
        mine = weights_of(m)
        theirs = ch_blocks(m, ref_w)
        cell["weight_abs"] = max_weight_diff(mine, theirs)
        del mine, theirs, ref_w
        cell.update(
            losses=losses, ref_losses=ref_losses, step_ms=wall * 1e3 / steps,
            launches=dict(ls.launches),
            device_launches=dict(ls.device_launches),
            collectives_per_step={k: v / steps for k, v in C.launches.items()
                                  if v},
            staged_mib_per_step=sum(C.staged_bytes.values()) / steps / 2**20,
            wh_local=tuple(m.state.params["lstm_0"]["wh"].shape))
        want = NL * steps
        if cell["launches"] != {"lstm_fwd": want, "lstm_bwd": want} or \
                cell["device_launches"] != {"lstm_fwd": want * NT,
                                            "lstm_bwd": want * (2 * NT + 1)}:
            raise AssertionError(
                f"channel (a) {dname}: kernel 7/8 launches "
                f"{cell['launches']}, device {cell['device_launches']}; want "
                f"{want} walks each, {want * NT} and {want * (2 * NT + 1)} "
                f"device kernels")
        if dtype == torch.float32:
            ok = (cell["loss_rel"] <= MESH_LOSS_REL
                  and cell["weight_abs"][0] <= MESH_WEIGHT_ABS)
        else:
            ok = (cell["loss_rel"] <= NMT_BF16_LOSS_REL
                  and cell["worst_grad"][1] <= NMT_GRAD_REL[dtype])
        if not ok:
            raise AssertionError(f"channel (a) {dname} on rank "
                                 f"{out['rank']}: {cell}")
        out[dname] = cell
        release(m)
        del m
    return out


def channel_rank_alexnet(steps):
    """(b) AlexNet at the sweep's shape (batch 256, 3 x 32 x 32, 10
    classes), f32, with channel_out on its five convs, on the same mesh,
    against the one-rank card run (cuDNN deterministic, not autotuned,
    TF32 off)."""
    import torch.distributed as dist
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    _, kw, batch, _, _ = SWEEP["alexnet"]
    data = sweep_batches("alexnet", batch, steps)

    def build(mesh=None, strategy=None):
        m = ft.build_alexnet(ft.FFConfig(batch_size=batch, seed=0),
                             batch_size=batch, device="cuda", mesh=mesh,
                             strategy=strategy, **kw)
        m.compile(optimizer=ft.SGDOptimizer(lr=0.01),
                  loss_type="sparse_categorical_crossentropy", metrics=[],
                  capture=False)
        return m

    ref = build()
    convs = [op.name for op in ref.ops if op.op_type == "conv2d"]
    ref_losses = [float(ref.train_batch(b)["loss"]) for b in data]
    ref_w = weights_of(ref)
    release(ref)
    del ref
    dist.barrier()
    m = build(make_mesh((1, CH_RANKS), ("data", "model")),
              ch_strategy(convs))
    t0 = time.perf_counter()
    losses = [float(m.train_batch(b)["loss"]) for b in data]
    torch.cuda.synchronize()
    cell = ch_compare(m, losses, ref_losses)
    cell.update(weight_abs=max_weight_diff(weights_of(m),
                                           ch_blocks(m, ref_w)),
                losses=losses, ref_losses=ref_losses,
                step_ms=(time.perf_counter() - t0) * 1e3 / steps,
                convs_split=[op for op in convs if m.executor._wwant[op][
                    "kernel"] == ("model",)])
    release(m)
    if not (cell["loss_rel"] <= MESH_LOSS_REL
            and cell["weight_abs"][0] <= MESH_WEIGHT_ABS
            and cell["convs_split"] == convs):
        raise AssertionError(f"channel (b) on rank {dist.get_rank()}: "
                             f"{cell}")
    return cell


def channel_rank_nccl(steps):
    """(d) one NCCL rank: the NMT (bf16, captured) on a (1, 1) data x
    model mesh with channel_out on both LSTMs against the same model
    without a mesh, bit for bit; at one rank the op takes the whole-H
    kernels (T device kernels a forward call, T + 2 a backward call), not
    the split launchers."""
    from flexflow_tpu_torch.kernels import lstm_scan as ls
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    batches = nmt_batches(steps)
    out = {}
    runs = {}
    for key, mesh, strat in (
            ("nomesh", None, None),
            ("mesh", make_mesh((1, 1), ("data", "model")),
             ch_strategy([f"lstm_{i}" for i in range(NL)]))):
        m = ch_nmt(torch.bfloat16, mesh, strat, capture=True)
        for counts in (ls.launches, ls.device_launches):
            counts.update(dict.fromkeys(counts, 0))
        losses = [float(m.train_batch(b)["loss"]) for b in batches]
        runs[key] = (losses, weights_of(m))
        out[key] = {"losses": losses, "captures": m.compile_counts(),
                    "launches": dict(ls.launches),
                    "device_launches": dict(ls.device_launches)}
        release(m)
        del m
    wdiff = max_weight_diff(runs["mesh"][1], runs["nomesh"][1])
    out["max_weight_diff"] = wdiff
    want = NL * steps
    for key in runs:
        if out[key]["device_launches"] != {"lstm_fwd": want * NT,
                                           "lstm_bwd": want * (NT + 2)}:
            raise AssertionError(f"channel (d) {key}: device launches "
                                 f"{out[key]['device_launches']}")
    if runs["mesh"][0] != runs["nomesh"][0] or wdiff[0] != 0.0:
        raise AssertionError(f"channel (d): the one-rank model axis changed "
                             f"the arithmetic: {out}")
    return out


def ch_split_walk(ls, xg0, wh0, h0w, c0b, hist, cs0, dys0, add):
    """Callables that run one block's kernels at the rank's shape,
    exactly the launches of a split walk: T forward steps reading
    h_{t-1} from the gathered history; T backward steps and T partial dh
    products, then dwh (the addend a fixed f32 block: timing only).
    Each is enqueued from Python a launch at a time; ``ch_graphed``
    replays them from a CUDA graph."""
    steps = xg0.shape[0]
    ys = torch.empty(cs0.shape, dtype=xg0.dtype, device="cuda")
    cs = torch.empty_like(cs0)
    dxg = torch.empty_like(xg0)
    dc = torch.zeros_like(c0b)
    part = torch.empty((xg0.shape[1], wh0.shape[0]), dtype=torch.float32,
                       device="cuda")
    dwh = torch.empty(tuple(wh0.shape), dtype=torch.float32, device="cuda")

    def fwd():
        for t in range(steps):
            ls._cuda_fwd_step(xg0[t], wh0, h0w if t == 0 else hist[t - 1],
                              c0b if t == 0 else cs0[t - 1], ys[t], cs[t])

    def bwd():
        dc.zero_()
        for t in reversed(range(steps)):
            ls._cuda_bwd_step(xg0[t], wh0, h0w if t == 0 else hist[t - 1],
                              c0b if t == 0 else cs0[t - 1], cs0[t], dys0[t],
                              add if t + 1 < steps else None, dxg[t], dc)
            ls._cuda_dh_partial(dxg[t], wh0, part)
        ls._cuda_dwh(h0w, hist, dxg, dwh)
    return fwd, bwd


def ch_graphed(fn):
    """fn's launches captured once into a CUDA graph: a callable that
    replays them, so that a timing reads the kernels' device time and
    not the host's enqueue of one launch at a time."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g.replay


def ch_split_bounds(dtype):
    """{kernel: (bound_ms, bound_by)} of one rank's split walk at T=NT,
    B=NB, Hin=NH, Hu=CH_HU. Flops: the forward's T products (B, Hin) x
    (Hin, 4Hu); the backward's three (the recompute, the partial dh,
    dwh). Bytes, each input read once and each output written once:
    forward xg, wh, the history h_{t-1} (T, B, Hin), c0 in, ys and cs
    out; backward xg, wh, the history, c0, cs, dys and the f32 addends
    in, dxg, the f32 partials (T, B, Hin), dwh (f32), dc0 out."""
    e = torch.tensor([], dtype=dtype).element_size()
    tbu, tbi = NT * NB * CH_HU, NT * NB * NH
    flops = 2.0 * NT * NB * NH * 4 * CH_HU
    fwd_bytes = ((4 * tbu + NH * 4 * CH_HU + tbi + tbu) * e
                 + NB * CH_HU * 4 + tbu * 4)
    bwd_bytes = ((4 * tbu + NH * 4 * CH_HU + tbi + tbu + 4 * tbu) * e
                 + 2 * NB * CH_HU * 4 + tbu * 4 * 2 + tbi * 4
                 + NH * 4 * CH_HU * 4)
    return {"lstm_fwd": bound(fwd_bytes, flops, dtype),
            "lstm_bwd": bound(bwd_bytes, 3 * flops, dtype)}


def ch_kernel_check(ls):
    """(c) Kernels 7-8 in the split form at a rank's shape (two blocks of
    the NMT's H = 1024, Hu = 512 each, stepped in one process with the
    halves concatenated each step), f32 and bf16: against the split
    plain versions (LSTM_TOL), the two-block forward against whole-H
    kernel 7 bit for bit (the same contraction), the two-block backward
    against whole-H kernel 8 (NMT_GRAD_REL); then one block's walk timed
    beside the whole-H kernels and cuDNN's layer in 3 interleaved
    rounds, with its bound: replayed from a CUDA graph (the kernels'
    device time: ms) and enqueued from Python a launch at a time, as an
    eager rank runs them (eager_ms)."""
    from flexflow_tpu_torch import resolve_device
    resolve_device("cuda")      # TF32 off: the plain versions and cuDNN
    res = {}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tol = LSTM_TOL[dtype]
        xg, wh, h0, c0, dys = lstm_inputs(dtype)
        xgs, whs = ls.blocks_of(xg, CH_RANKS), ls.blocks_of(wh, CH_RANKS)
        c0s = [c.contiguous() for c in c0.chunk(CH_RANKS, 1)]
        dyss = [d.contiguous() for d in dys.chunk(CH_RANKS, 2)]
        h0w = h0.float().to(dtype).contiguous()
        css, hist = ls.lstm_fwd_split(xgs, whs, h0w, c0s, ls.cat_gather)
        css_p, hist_p = ls.lstm_fwd_split(xgs, whs, h0w, c0s, ls.cat_gather,
                                          plain=True)
        torch.cuda.synchronize()
        errs = {"lstm_fwd": [
            check_err(f"split lstm_fwd {dname} ys", hist, hist_p, tol, True),
            *(check_err(f"split lstm_fwd {dname} cs{b}", c, p, tol, True)
              for b, (c, p) in enumerate(zip(css, css_p)))]}
        ys, cs = ls.lstm_fwd_cuda(xg, wh, h0, c0)
        bitwise = bool(torch.equal(hist, ys)
                       and torch.equal(torch.cat(css, 2), cs))
        got = ls.lstm_bwd_split(xgs, whs, h0w, c0s, css, hist, dyss,
                                ls.sum_scatter)
        want = ls.lstm_bwd_split(xgs, whs, h0w, c0s, css, hist, dyss,
                                 ls.sum_scatter, plain=True)
        torch.cuda.synchronize()
        errs["lstm_bwd"] = [
            check_err(f"split lstm_bwd {dname} {n}{b}", a, p, tol, True)
            for n, ga, gp in zip(("dxg", "dwh", "dh0", "dc0"), got, want)
            for b, (a, p) in enumerate(zip(ga, gp))]
        whole = ls.lstm_bwd_cuda(xg, wh, h0, c0, ys, cs, dys)

        def joined(blocks):
            lead, hu = blocks[0].shape[:-1], blocks[0].shape[-1] // 4
            return torch.stack([b.reshape(lead + (4, hu)) for b in blocks],
                               dim=-2).reshape(lead + (-1,))
        mine = (joined(got[0]), joined(got[1]), torch.cat(got[2], 1),
                torch.cat(got[3], 1))
        vs_whole = {n: float((a.float() - w.float()).norm()
                             / w.float().norm())
                    for n, a, w in zip(("dxg", "dwh", "dh0", "dc0"), mine,
                                       whole)}
        del got, want, mine, css_p, hist_p
        if not bitwise:
            raise AssertionError(f"channel (c) {dname}: the two-block "
                                 f"forward differs from whole-H kernel 7")
        if max(vs_whole.values()) > NMT_GRAD_REL[dtype]:
            raise AssertionError(f"channel (c) {dname}: the two-block "
                                 f"backward against whole-H kernel 8 "
                                 f"{vs_whole} > {NMT_GRAD_REL[dtype]}")
        add = torch.randn((NB, CH_HU), device="cuda") * 1e-2
        sfwd, sbwd = ch_split_walk(ls, xgs[0], whs[0], h0w, c0s[0], hist,
                                   css[0], dyss[0], add)
        bargs = (xg, wh, h0, c0, ys, cs, dys)
        fns = {"split_fwd": ch_graphed(sfwd), "split_bwd": ch_graphed(sbwd),
               "split_fwd_eager": sfwd, "split_bwd_eager": sbwd,
               "whole_fwd": lambda: ls.lstm_fwd_cuda(xg, wh, h0, c0),
               "whole_bwd": lambda: ls.lstm_bwd_cuda(*bargs)}
        lib = cudnn_fns(dtype)
        if lib is not None:
            fns.update(cudnn_fwd=lib[0], cudnn_bwd=lib[2])
        rounds = yardstick(fns)
        bounds = ch_split_bounds(dtype)
        for kname, short in (("lstm_fwd", "fwd"), ("lstm_bwd", "bwd")):
            lib_r = rounds.get(f"cudnn_{short}")
            b_ms, b_by = bounds[kname]
            res.setdefault(kname, {})[dname] = {
                "shape": f"T={NT} B={NB} Hin={NH} Hu={CH_HU}",
                "max_abs_err": max(x[0] for x in errs[kname]),
                "err_over_max_ref": max(x[1] for x in errs[kname]),
                "ms": statistics.median(rounds[f"split_{short}"]),
                "ms_rounds": rounds[f"split_{short}"],
                "eager_ms": statistics.median(
                    rounds[f"split_{short}_eager"]),
                "eager_ms_rounds": rounds[f"split_{short}_eager"],
                "whole_ms": statistics.median(rounds[f"whole_{short}"]),
                "whole_ms_rounds": rounds[f"whole_{short}"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None if lib_r is None
                else statistics.median(lib_r),
                "library_ms_rounds": lib_r,
                **({"fwd_bit_for_bit_vs_whole": bitwise}
                   if kname == "lstm_fwd" else
                   {"bwd_rel_vs_whole": vs_whole})}
            c = res[kname][dname]
            log(f"channel (c) kernel {kname} split [{dname}, {c['shape']}]:"
                f" err/max|plain| {c['err_over_max_ref']:.3g} (tol {tol}); "
                + (f"two-block forward = whole-H kernel 7 bit for bit: "
                   f"{bitwise}" if kname == "lstm_fwd" else
                   f"two-block backward vs whole-H kernel 8 (rel L2) "
                   f"{ {k: f'{v:.3g}' for k, v in vs_whole.items()} }")
                + f"; split ms {spread(rounds[f'split_{short}'])} (graph "
                f"replay; enqueued a launch at a time "
                f"{spread(rounds[f'split_{short}_eager'])}) vs whole-H"
                f" {spread(rounds[f'whole_{short}'])} "
                f"({c['ms'] / c['whole_ms']:.3f}x), bound {b_ms:.4f} "
                f"({b_by}), cuDNN H={NH} "
                f"{'null' if lib_r is None else spread(lib_r)}")
        del xg, wh, h0, c0, dys, xgs, whs, css, hist, ys, cs, whole, fns
        del lib, bargs, sfwd, sbwd
        torch.cuda.empty_cache()
    return res


def channel_phase(ls, card: str):
    """channel_out on conv and LSTM (see the module docstring): (c) the
    split kernels in this process, then (a) and (b) on two gloo ranks
    sharing the card, (d) on one NCCL rank. The ranks are processes
    spawned after every kernel was built."""
    import tempfile
    from flexflow_tpu_torch.parallel.launch import RankPool
    t0 = time.perf_counter()
    res = {"kernels": ch_kernel_check(ls)}
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="ff_ch_"))
    with RankPool(CH_RANKS, str(tmp / "g"), backend="gloo", device="cuda",
                  threads=0, timeout_s=600) as pool:
        res["nmt"] = pool.run(channel_rank_nmt, CH_STEPS)
        res["alexnet"] = pool.run(channel_rank_alexnet, CH_STEPS)
    for dname in ("f32", "bf16"):
        cells = [r[dname] for r in res["nmt"]]
        c0 = cells[0]
        log(f"channel (a) nmt {dname} [{card}]: (1, 2) data x model, "
            f"channel_out on both LSTMs (wh {c0['wh_local']} a rank), "
            f"{CH_STEPS} eager steps against the one-rank card run: loss "
            f"rel {[f'{c['loss_rel']:.3e}' for c in cells]}, weights abs "
            f"{[f'{c['weight_abs'][0]:.3e}' for c in cells]}, worst "
            f"gradient {[c['worst_grad'] for c in cells]}; kernel 7/8 "
            f"launches a rank {[c['launches'] for c in cells]}, device "
            f"{[c['device_launches'] for c in cells]}; collectives a step "
            f"{c0['collectives_per_step']}; staged "
            f"{[round(c['staged_mib_per_step'], 1) for c in cells]} MiB a "
            f"step; eager step {[round(c['step_ms'], 1) for c in cells]} "
            f"ms (two gloo ranks on one card: no speed)")
    cells = res["alexnet"]
    log(f"channel (b) alexnet f32 b=256 [{card}]: channel_out on "
        f"{cells[0]['convs_split']}: loss rel "
        f"{[f'{c['loss_rel']:.3e}' for c in cells]}, weights abs "
        f"{[f'{c['weight_abs'][0]:.3e}' for c in cells]}, eager step "
        f"{[round(c['step_ms'], 1) for c in cells]} ms")
    with RankPool(1, str(tmp / "n"), backend="nccl", device="cuda",
                  threads=0, timeout_s=600) as pool:
        res["nccl"] = pool.run(channel_rank_nccl, CH_NCCL_STEPS)[0]
    d = res["nccl"]
    log(f"channel (d) one NCCL rank, (1, 1) data x model, nmt bf16 "
        f"captured: losses {d['mesh']['losses']} = no mesh "
        f"{d['nomesh']['losses']}, weights max diff "
        f"{d['max_weight_diff'][0]}; device launches "
        f"{d['mesh']['device_launches']} (whole-H: {NT} a forward call, "
        f"{NT + 2} a backward call)")
    res["phase_s"] = time.perf_counter() - t0
    log(f"channel phase: {res['phase_s']:.1f} s")
    return res


# ------------------- layouts over several mesh axes: four gloo ranks
LAY_STEPS = 2
LAY_NCCL_STEPS = 2
LAY_RANKS = 4
# (a) the FSDP layout: every linear's channel_out, attention's head and
# the embeddings' vocab over ("model", "data") on (2, 2) data x model
LAY_ENTRY = ("model", "data")
# (b) the sequence over ("seq", "model") on (1, 2, 2): 8 heads over the
# product of 4 in the all-to-all core, 2 a rank
LAY_SEQ = ("seq", "model")
LAY_HEADS = TH // 4


def lay_strategy(kind):
    from flexflow_tpu_torch.parallel.pconfig import OpStrategy, Strategy
    if kind == "fsdp":
        return Strategy(default=OpStrategy({
            "sample": "data", "channel_out": LAY_ENTRY, "head": LAY_ENTRY,
            "vocab": LAY_ENTRY}))
    return Strategy(default=OpStrategy({"sample": "data", "seq": LAY_SEQ}))


def lay_mesh(kind):
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    if kind == "fsdp":
        return make_mesh((2, 2), ("data", "model"))
    return make_mesh((1, 2, 2), ("data", "model", "seq"))


def layout_rank_lm(kind, steps):
    """(a) / (b) on a gloo rank sharing the card: the README LM at full
    width on the layout ``kind`` ("fsdp": (2, 2) data x model with
    channel_out, head and vocab over ("model", "data"); "seq": (1, 2, 2)
    data x model x seq with seq over ("seq", "model")), eager, against
    the one-device run of the same weights on the same card (each rank
    runs that reference itself): f32 and under the bf16 policy; "seq"
    through the all-to-all core and through the ring."""
    import torch.distributed as dist
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops import attention as att
    from flexflow_tpu_torch.parallel import collectives as C
    rank = dist.get_rank()
    data = lm_batches(steps)
    mesh, st = lay_mesh(kind), lay_strategy(kind)
    modes = ("alltoall", "ring") if kind == "seq" else ("auto",)
    seen = []
    bshd = fa.flash_attention_bshd

    def flash_spy(q, k, v, **kw):
        seen.append(tuple(q.shape))
        return bshd(q, k, v, **kw)

    out = {"rank": rank}
    for dtype in ("float32", "bfloat16"):
        ref = lm_model(dtype, capture=False)
        init = _host_params(ref)
        whole_bytes = sum(w.numel() * w.element_size()
                          for p in ref.state.params.values()
                          for w in p.values())
        ref_losses = [float(ref.train_batch(b)["loss"]) for b in data]
        ref_w = _host_params(ref)
        release(ref)
        del ref
        for mode in modes:
            m = lm_model(dtype, capture=False, mesh=mesh, strategy=st,
                         sp_attention=mode)
            resident = sum(w.numel() * w.element_size()
                           for p in m.state.params.values()
                           for w in p.values())
            split = sum(1 for op, p in m.executor._wstore.items()
                        for k, s in p.items() if any(
                            e is not None for e in s))
            # the op's core (ops/attention.py) and the all-to-all core
            # (parallel/ulysses.py) both reach the entry point
            fa.flash_attention_bshd = att.flash_attention_bshd = flash_spy
            seen.clear()
            C.reset_counts()
            fl0 = dict(fa.launches)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = [float(m.train_batch(b)["loss"]) for b in data]
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3 / steps
            finally:
                fa.flash_attention_bshd = att.flash_attention_bshd = bshd
            flash = {k: fa.launches[k] - fl0.get(k, 0)
                     for k in ("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv")}
            coll = {k: v / steps for k, v in C.launches.items() if v}
            staged = sum(C.staged_bytes.values()) / steps / 2**20
            glob = {f"{op}.{k}": torch.from_numpy(v)
                    for op in m.state.params
                    for k, v in m.get_weights(op).items()}
            release(m)
            del m
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(losses, ref_losses))
            wdiff = max(float((glob[n] - ref_w[n]).abs().max())
                        for n in ref_w)
            upd = max(float((glob[n] - ref_w[n]).norm()
                            / (ref_w[n] - init[n]).norm())
                      for n in ref_w if float((ref_w[n] - init[n]).norm()))
            if dtype == "float32":
                lim, got = (MESH_LOSS_REL, MESH_WEIGHT_ABS), wdiff
            else:
                lim, got = (SP_BF16_LOSS_REL, SP_BF16_UPDATE_REL), upd
            cell = {"losses": losses, "ref_losses": ref_losses,
                    "max_loss_rel": rel, "max_weight_abs": wdiff,
                    "max_update_rel": upd, "limits": lim,
                    "resident_param_bytes": resident,
                    "whole_param_bytes": whole_bytes,
                    "split_weights": split,
                    "flash_launches": flash,
                    "flash_shape": seen[0] if seen else None,
                    "collectives_per_step": coll,
                    "staged_mib_per_step": staged, "step_ms": step_ms}
            out[f"{dtype} {mode}"] = cell
            if not (rel <= lim[0] and got <= lim[1]):
                raise AssertionError(
                    f"layout ({kind}) {dtype} {mode} rank {rank}: against "
                    f"the one-device run loss rel {rel} (limit {lim[0]}), "
                    f"weights abs {wdiff}, updates rel {upd} (limit "
                    f"{lim[1]})")
            layers = LM_ARCH["num_layers"]
            want = 0 if mode == "ring" else layers * steps
            shape = ((LB // 2, TS, TH // 2, TD) if kind == "fsdp"
                     else (LB, TS, LAY_HEADS, TD))
            if any(v != want for v in flash.values()) or (
                    want and cell["flash_shape"] != shape):
                raise AssertionError(
                    f"layout ({kind}) {dtype} {mode}: flash launches "
                    f"{flash} on {cell['flash_shape']}, want {want} each "
                    f"on {shape}")
            if kind == "fsdp" and not resident * 3 < whole_bytes:
                raise AssertionError(
                    f"layout (a) rank {rank}: {resident} resident "
                    f"parameter bytes of {whole_bytes}")
    return out


def layout_rank_nccl(steps):
    """(d) one NCCL rank: the LM (bf16 policy, captured) on a (1, 1)
    data x model mesh carrying (a)'s tuple entries against the same
    model without a mesh, bit for bit."""
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import collectives as C
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    data = lm_batches(steps, seed=3)
    out, runs = {}, {}
    for key, mesh, st in (
            ("nomesh", None, None),
            ("mesh", make_mesh((1, 1), ("data", "model")),
             lay_strategy("fsdp"))):
        m = lm_model("bfloat16", capture=True, mesh=mesh, strategy=st)
        C.reset_counts()
        fl0 = dict(fa.launches)
        losses = [float(m.train_batch(b)["loss"]) for b in data]
        runs[key] = (losses, weights_of(m))
        out[key] = {"losses": losses, "captures": m.compile_counts(),
                    "collectives": {k: v for k, v in C.launches.items()
                                    if v},
                    "flash_launches": {k: fa.launches[k] - fl0.get(k, 0)
                                       for k in ("flash_fwd",
                                                 "flash_bwd_dq",
                                                 "flash_bwd_dkv")}}
        release(m)
        del m
    wdiff = max_weight_diff(runs["mesh"][1], runs["nomesh"][1])
    out["max_weight_diff"] = wdiff
    if runs["mesh"][0] != runs["nomesh"][0] or wdiff[0] != 0.0 \
            or out["mesh"]["captures"].get("train_step") != 1:
        raise AssertionError(f"layout (d): the one-rank tuple entries "
                             f"changed the arithmetic: {out}")
    return out


def layout_phase(fa, card: str):
    """Layouts over several mesh axes (see the module docstring): (a)
    and (b) on four gloo ranks sharing the card, (c) kernels 2-4 at
    (b)'s per-rank all-to-all shape in this process, (d) on one NCCL
    rank. Four ranks that cannot share the card fail the phase."""
    import tempfile
    from flexflow_tpu_torch.parallel.launch import RankPool
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="ff_lay_"))
    res = {}
    with RankPool(LAY_RANKS, str(tmp / "g"), backend="gloo",
                  device="cuda", threads=2, timeout_s=900) as pool:
        res["fsdp"] = pool.run(layout_rank_lm, "fsdp", LAY_STEPS)
        res["seq"] = pool.run(layout_rank_lm, "seq", LAY_STEPS)
    for kind, where in (("fsdp", f"(2, 2) data x model, channel_out, "
                                 f"head and vocab over {LAY_ENTRY}"),
                        ("seq", f"(1, 2, 2) data x model x seq, seq over "
                                f"{LAY_SEQ}")):
        tag = "(a)" if kind == "fsdp" else "(b)"
        for key in [k for k in res[kind][0] if k != "rank"]:
            c = [r[key] for r in res[kind]]
            log(f"layout {tag} LM {key} on {where}, four gloo ranks on one "
                f"card ({card}): vs the one-device run loss rel "
                f"{max(x['max_loss_rel'] for x in c):.3e}, weights abs "
                f"{max(x['max_weight_abs'] for x in c):.3e}, updates rel "
                f"{max(x['max_update_rel'] for x in c):.3e} (limits "
                f"{c[0]['limits'][0]:.3g}, {c[0]['limits'][1]:.3g}); "
                f"resident parameter bytes a rank "
                f"{[x['resident_param_bytes'] for x in c]} of "
                f"{c[0]['whole_param_bytes']} ({c[0]['split_weights']} "
                f"weights split); flash launches a rank "
                f"{[x['flash_launches'] for x in c]} on "
                f"{c[0]['flash_shape']}; collectives a step "
                f"{c[0]['collectives_per_step']}; staged "
                f"{[round(x['staged_mib_per_step'], 1) for x in c]} MiB a "
                f"step; eager step {[round(x['step_ms'], 1) for x in c]} "
                f"ms (four gloo ranks on one card: no speed)")
    res["kernels"] = ulysses_kernel_check(fa, heads=LAY_HEADS,
                                          tag="layout", phase="layout (c)")
    with RankPool(1, str(tmp / "n"), backend="nccl", device="cuda",
                  threads=0, timeout_s=600) as pool:
        res["nccl"] = pool.run(layout_rank_nccl, LAY_NCCL_STEPS)[0]
    d = res["nccl"]
    log(f"layout (d) one NCCL rank, (1, 1) data x model with (a)'s tuple "
        f"entries, LM bf16 captured: losses {d['mesh']['losses']} = no "
        f"mesh {d['nomesh']['losses']}, weights max diff "
        f"{d['max_weight_diff'][0]}; collectives {d['mesh']['collectives']}"
        f"; flash launches {d['mesh']['flash_launches']}")
    res["phase_s"] = time.perf_counter() - t0
    log(f"layout phase: {res['phase_s']:.1f} s")
    return res


# --------------------------------------------------------------------------
# the frontends: Keras, the native loader, torch.fx and ONNX
# --------------------------------------------------------------------------
# (a) the Keras text classifier at the NMT's full width: token ids (NB,
# NT) over a vocabulary of NV -> Embedding(NV, NH) -> LSTM(NH, every
# position) -> LSTM(NH, the last) -> Dense(KERAS_CLASSES, softmax), SGD
# lr 0.01, trained by keras.Model.fit for KERAS_STEPS epochs of one batch
# (one step and one loss each); the label is the first token modulo the
# classes, so it rides the recurrence to the last position
KERAS_CLASSES = 46
KERAS_STEPS = 3
KERAS_PREDICT = 2 * NB
KERAS_TIMED = 10
# kernel path vs the scan cell: the NMT phase's limits (losses at
# NMT_F32_LOSS_REL, each weight's gradient at NMT_GRAD_REL); predict's
# probabilities at NMT_F32_LOSS_REL of the largest, and argmax agreement
# at least KERAS_ARGMAX (two near-tied classes may swap)
KERAS_ARGMAX = 0.98
# (b) the loaders alone: LOADER_BATCHES batches a round, LOADER_ROUNDS
# interleaved rounds
LOADER_BATCHES = 16
LOADER_ROUNDS = 3
# (c) the CIFAR-10 CNN of examples/python/pytorch/cifar10_cnn_torch.py at
# batch 64, imported through torch.fx and through ONNX: each forward on
# the card against the module's own at FX_REL of the largest output
FX_BATCH = 64
FX_REL = 1e-5
FX_STEPS = 3
# (d) the host embedding-bag at DLRM's width: a table of BAG_VOCAB rows
# of DLRM_DIM, BAG_BATCH bags of BAG_LEN ids, a tenth of them padding
BAG_VOCAB, BAG_BATCH, BAG_LEN = 100_000, 8192, 8
BAG_REL = 1e-6


def keras_classifier(capture=True, use_pallas=None):
    """The Keras classifier compiled on the card, weights from the
    port's numpy streams at seed 0 (the same for every build).
    ``capture=False`` runs each step eagerly; ``use_pallas=False`` puts
    its LSTM ops on the scan cell."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.frontends import keras
    keras.layers.reset_layer_uids()
    m = keras.Sequential([
        keras.layers.Embedding(NV, NH, input_shape=(NT,)),
        keras.layers.LSTM(NH, return_sequences=True),
        keras.layers.LSTM(NH),
        keras.layers.Dense(KERAS_CLASSES, activation="softmax"),
    ], config=FFConfig(batch_size=NB, seed=0))
    m.compile(optimizer=keras.SGD(learning_rate=0.01),
              loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    ff = m.build_model(NB)
    if not capture:
        ff.executor.programs.capture = False
    for op in ff.ops:
        if op.op_type == "lstm":
            op.use_pallas = use_pallas
    return m


def keras_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, NV, (n, NT)).astype(np.int32)
    return x, (x[:, 0] % KERAS_CLASSES).astype(np.int32)


def keras_fit(m, x, y, record=False):
    """KERAS_STEPS epochs of keras.Model.fit over one batch: (losses,
    host weights, each step's gradients if ``record`` — an eager model
    only: a replay runs no Python)."""
    ex, grads = m.ffmodel.executor, []
    if record:
        compute = ex._compute_grads

        def recorder(params, batch, key=None, **kw):
            loss, logits, g, sparse_idx = compute(params, batch, key, **kw)
            grads.append({f"{op}.{k}": w.detach().clone()
                          for op, p in g.items() for k, w in p.items()})
            return loss, logits, g, sparse_idx

        ex._compute_grads = recorder
    try:
        hist = m.fit(x, y, batch_size=NB, epochs=KERAS_STEPS, verbose=False)
    finally:
        if record:
            del ex._compute_grads
    return [h["loss"] for h in hist], weights_of(m.ffmodel), grads


def keras_path(ls, sr, card: str):
    """(a): the scan cell and the kernels eagerly with their gradients
    recorded, then the main path — the kernels, the step captured — with
    the launch counts zeroed just before its fit and read just after,
    and predict on KERAS_PREDICT rows."""
    x, y = keras_data(NB)
    xp, _ = keras_data(KERAS_PREDICT, seed=1)
    scan = keras_classifier(capture=False, use_pallas=False)
    lsc, wsc, gsc = keras_fit(scan, x, y, record=True)
    eager = keras_classifier(capture=False)
    le, we, ge = keras_fit(eager, x, y, record=True)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    errs = grad_errs(ge, gsc)
    del ge, gsc
    m = keras_classifier()
    for counts in (ls.launches, ls.device_launches, sr.launches):
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lc, wc, _ = keras_fit(m, x, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches, device = dict(ls.launches), dict(ls.device_launches)
    rows = dict(sr.launches)
    for counts in (ls.launches, ls.device_launches):
        counts.update(dict.fromkeys(counts, 0))
    pc = m.predict(xp, batch_size=NB)
    plaunch, pdevice = dict(ls.launches), dict(ls.device_launches)
    ps = scan.predict(xp, batch_size=NB)
    # the captured step's wall, replayed KERAS_TIMED times
    ff = m.ffmodel
    batch = {ff.input_tensors[0].name: x, "label": y}
    float(ff.train_batch(batch)["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [ff.train_batch(batch) for _ in range(KERAS_TIMED)]
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / KERAS_TIMED
    if not all(math.isfinite(float(t["loss"])) for t in timed):
        raise AssertionError("keras: a non-finite loss in the timed steps")
    del m, scan, ff, timed
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(errs, key=errs.get)
    wdiff = max_weight_diff(we, wc)
    prob_rel = float(np.abs(pc - ps).max() / np.abs(ps).max())
    agree = float((pc.argmax(1) == ps.argmax(1)).mean())
    res = {"losses": lc, "eager_losses": le, "scan_losses": lsc,
           "grad_rel": errs, "worst_grad": [worst, errs[worst]],
           "launches": launches, "device_launches": device,
           "sparse_rows_launches": rows, "predict_launches": plaunch,
           "predict_device_launches": pdevice,
           "predict_prob_rel": prob_rel, "predict_argmax_agree": agree,
           "captured_vs_eager_weights": wdiff,
           "scan_vs_kernel_weights": max_weight_diff(wsc, wc),
           "fit_s": fit_s, "step_ms": step_ms}
    log(f"frontend (a) keras LSTM classifier [{card}]: Embedding({NV}, "
        f"{NH}) -> LSTM({NH}) x {NL} -> Dense({KERAS_CLASSES}), batch {NB} "
        f"x {NT}, f32, {KERAS_STEPS} keras fit steps captured: losses "
        f"{lc}, eager {le} (weights max diff {wdiff[0]}); the scan cell "
        f"{lsc} (tol rel {NMT_F32_LOSS_REL}); gradient |g_k - g_scan| / "
        f"|g_scan| worst {errs[worst]:.3g} at {worst} (limit "
        f"{NMT_GRAD_REL[torch.float32]}); launches {launches}, device "
        f"{device}, sparse_rows {rows}; fit {fit_s:.2f} s, capture "
        f"included; a captured step {step_ms:.3f} ms over {KERAS_TIMED}")
    log(f"frontend (a) keras predict {KERAS_PREDICT} rows: lstm launches "
        f"{plaunch} (device {pdevice}); probabilities vs the scan cell rel "
        f"{prob_rel:.3e} (limit {NMT_F32_LOSS_REL}), argmax agreement "
        f"{agree:.4f} (at least {KERAS_ARGMAX})")
    want = NL * KERAS_STEPS
    if launches != {"lstm_fwd": want, "lstm_bwd": want} or device != {
            "lstm_fwd": want * NT, "lstm_bwd": want * (NT + 2)}:
        raise AssertionError(f"keras lstm launches {launches}, device "
                             f"{device}: want {want} calls each")
    if rows != {"sparse_rows_exact": KERAS_STEPS, "sparse_rows_lazy": 0}:
        raise AssertionError(f"keras sparse_rows launches {rows}")
    wantp = NL * KERAS_PREDICT // NB
    if plaunch != {"lstm_fwd": wantp, "lstm_bwd": 0} or \
            pdevice["lstm_fwd"] != wantp * NT:
        raise AssertionError(f"keras predict launches {plaunch} {pdevice}")
    if lc != le or wdiff[0] != 0.0:
        raise AssertionError(f"keras captured steps differ from eager: "
                             f"losses {lc} vs {le}, weights {wdiff}")
    if not all(abs(a - b) <= NMT_F32_LOSS_REL * abs(b)
               for a, b in zip(lc, lsc)):
        raise AssertionError(f"keras losses {lc} vs scan {lsc}")
    if not errs[worst] <= NMT_GRAD_REL[torch.float32]:
        raise AssertionError(f"keras gradient of {worst} differs by "
                             f"{errs[worst]}")
    if not (prob_rel <= NMT_F32_LOSS_REL and agree >= KERAS_ARGMAX):
        raise AssertionError(f"keras predict rel {prob_rel}, argmax "
                             f"agreement {agree}")
    return res


@contextlib.contextmanager
def native_off(off=True):
    """FLEXFLOW_TORCH_NO_NATIVE set inside (the library turned off)."""
    import os
    if off:
        os.environ["FLEXFLOW_TORCH_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("FLEXFLOW_TORCH_NO_NATIVE", None)


def loader_path(card: str):
    """(b): fit(prefetch=True) on the classifier through the native
    loader and through the Python loader, 3 steps each, bit for bit;
    then the loaders alone: the host gather of a batch, and an epoch of
    LOADER_BATCHES batches staged to the card."""
    from flexflow_tpu_torch import native
    from flexflow_tpu_torch.core.dataloader import DataLoaderSet
    from flexflow_tpu_torch.native import wrappers as nw
    t0 = time.perf_counter()
    native.get_lib()           # built from this checkout's csrc, if absent
    build_s = time.perf_counter() - t0
    x, y = keras_data(3 * NB, seed=2)
    calls = [0]
    real_next = nw.NativePrefetchLoader.next_batch

    def counted(self):
        calls[0] += 1
        return real_next(self)

    out, weights = {}, {}
    nw.NativePrefetchLoader.next_batch = counted
    try:
        for name in ("native", "python"):
            with native_off(name == "python"):
                calls[0] = 0
                m = keras_classifier()
                ff = m.ffmodel
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                h = ff.fit({ff.input_tensors[0].name: x}, y, batch_size=NB,
                           epochs=1, verbose=False, prefetch=True)
                torch.cuda.synchronize()
                out[name] = {"loss": h[0]["loss"],
                             "native_batches": calls[0],
                             "fit_s": time.perf_counter() - t1}
                weights[name] = weights_of(ff)
                del m, ff
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        nw.NativePrefetchLoader.next_batch = real_next
    diff = max_weight_diff(weights["native"], weights["python"])
    # the loaders alone, in interleaved rounds
    xl, yl = keras_data(LOADER_BATCHES * NB, seed=3)
    data = {"input": xl, "label": yl}
    order = np.random.default_rng(4).permutation(len(yl))
    gather = {"native": [], "numpy": []}
    epoch = {"native": [], "python": []}
    nl = nw.NativePrefetchLoader(data, NB)
    try:
        for _ in range(LOADER_ROUNDS):
            nl.start_epoch(order)
            t1 = time.perf_counter()
            for _ in range(LOADER_BATCHES):
                b = nl.next_batch()
                _ = {k: np.array(v, copy=True) for k, v in b.items()}
            gather["native"].append(
                1e3 * (time.perf_counter() - t1) / LOADER_BATCHES)
            t1 = time.perf_counter()
            for i in range(LOADER_BATCHES):
                sel = order[i * NB:(i + 1) * NB]
                _ = {k: v[sel] for k, v in data.items()}
            gather["numpy"].append(
                1e3 * (time.perf_counter() - t1) / LOADER_BATCHES)
            for name in ("native", "python"):
                ds = DataLoaderSet(data, NB, shuffle=False, device="cuda",
                                   use_native=name == "native")
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in ds.iter_with_order(order):
                    pass
                torch.cuda.synchronize()
                epoch[name].append(
                    1e3 * (time.perf_counter() - t1) / LOADER_BATCHES)
                ds.close()
    finally:
        nl.close()
    res = {**out, "weights_diff": diff, "native_build_s": build_s,
           "library": native.library_path().name, "gather_ms": gather,
           "epoch_ms_per_batch": epoch, "batch_bytes": NB * (NT + 1) * 4}
    log(f"frontend (b) fit(prefetch=True) [{card}]: native loader (library "
        f"{res['library']}, ready in {build_s:.2f} s) vs Python loader: "
        f"losses {out['native']['loss']} / {out['python']['loss']}, weights "
        f"max diff {diff[0]}; native batches taken "
        f"{out['native']['native_batches']} / "
        f"{out['python']['native_batches']}; fit s "
        f"{out['native']['fit_s']:.2f} / {out['python']['fit_s']:.2f} "
        f"(capture included)")
    log(f"frontend (b) loader host ms a batch of {NB} x {NT} int32 ids and "
        f"labels ({res['batch_bytes']} B): gather native {gather['native']}"
        f" numpy {gather['numpy']}; an epoch of {LOADER_BATCHES} batches "
        f"staged to the card, ms a batch: native {epoch['native']} python "
        f"{epoch['python']}")
    if out["native"]["native_batches"] != 3 or \
            out["python"]["native_batches"] != 0:
        raise AssertionError(f"loader paths not taken: {out}")
    if diff[0] != 0.0 or out["native"]["loss"] != out["python"]["loss"]:
        raise AssertionError(f"fit(prefetch) native vs python: {out}, "
                             f"weights {diff}")
    return res


class CifarCNN(torch.nn.Module):
    """The CNN of examples/python/pytorch/cifar10_cnn_torch.py: conv
    3->32 and 32->32 with a residual add, max-pool, fc 8192->256, fc
    256->10, softmax."""

    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(3, 32, 3, padding=1)
        self.relu1 = nn.ReLU()
        self.conv2 = nn.Conv2d(32, 32, 3, padding=1)
        self.relu2 = nn.ReLU()
        self.pool = nn.MaxPool2d(2)
        self.flat = nn.Flatten()
        self.fc1 = nn.Linear(32 * 16 * 16, 256)
        self.relu3 = nn.ReLU()
        self.fc2 = nn.Linear(256, 10)
        self.sm = nn.Softmax(dim=-1)

    def forward(self, x):
        a = self.relu1(self.conv1(x))
        b = self.relu2(self.conv2(a))
        t = self.pool(a + b)
        t = self.relu3(self.fc1(self.flat(t)))
        return self.sm(self.fc2(t))


def import_path(card: str):
    """(c): the CIFAR-10 CNN through torch.fx (PyTorchModel.apply, then
    import_weights) and through ONNX (export_torch_onnx, then ONNXModel,
    its weights staged for compile), each forward on the card against
    the module's own, then FX_STEPS captured steps each from the same
    weights and batches."""
    import copy
    import tempfile
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.frontends.onnx import (HAS_ONNX, ONNXModel,
                                                   export_torch_onnx)
    from flexflow_tpu_torch.frontends.torchfx import PyTorchModel
    torch.manual_seed(0)
    module = CifarCNN().eval()
    host_module = copy.deepcopy(module)
    module = module.cuda()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((FX_BATCH, 3, 32, 32), np.float32)
    ys = [rng.integers(0, 10, FX_BATCH).astype(np.int32)
          for _ in range(FX_STEPS)]
    with torch.no_grad():
        want = module(torch.from_numpy(x).cuda())
    res = {"onnx_package": HAS_ONNX}
    with tempfile.TemporaryDirectory() as td:
        path = str(Path(td) / "cifar10_cnn.onnx")
        t0 = time.perf_counter()
        export_torch_onnx(host_module, torch.from_numpy(x), path,
                          input_names=["input"], output_names=["output"])
        res["onnx_export_s"] = time.perf_counter() - t0
        res["onnx_bytes"] = Path(path).stat().st_size
        for kind in ("torchfx", "onnx"):
            ff = FFModel(FFConfig(batch_size=FX_BATCH))
            inp = ff.create_tensor((FX_BATCH, 3, 32, 32), name="input")
            if kind == "torchfx":
                ptm = PyTorchModel(module)
                ptm.apply(ff, [inp])
            else:
                ONNXModel(path).apply(ff, {"input": inp})
            ff.compile(optimizer=SGDOptimizer(lr=0.01),
                       loss_type="sparse_categorical_crossentropy",
                       metrics=["accuracy"])
            if kind == "torchfx":
                ptm.import_weights(ff)
            got = ff.forward({"input": x})
            rel = float((got - want).abs().max() / want.abs().max())
            losses = [float(ff.train_batch({"input": x, "label": ys[i]})
                            ["loss"]) for i in range(FX_STEPS)]
            res[kind] = {"forward_rel": rel, "losses": losses,
                         "ops": [op.op_type for op in ff.ops],
                         "captures": ff.compile_counts()}
            del ff
            gc.collect()
            torch.cuda.empty_cache()
    for kind in ("torchfx", "onnx"):
        r = res[kind]
        log(f"frontend (c) {kind} CIFAR-10 CNN [{card}] batch {FX_BATCH} "
            f"x 3 x 32 x 32, f32: forward vs the module's on the card rel "
            f"{r['forward_rel']:.3e} (limit {FX_REL}); ops {r['ops']}; "
            f"{FX_STEPS} steps {r['captures']}, losses {r['losses']}")
    log(f"frontend (c) onnx: exported by torch's TorchScript exporter in "
        f"{res['onnx_export_s']:.2f} s ({res['onnx_bytes']} B), read by "
        f"{'the onnx package' if HAS_ONNX else 'the wire reader'}")
    la, lb = res["torchfx"]["losses"], res["onnx"]["losses"]
    if not all(r["forward_rel"] <= FX_REL for r in (res["torchfx"],
                                                    res["onnx"])):
        raise AssertionError(f"imported forwards differ: {res}")
    if not all(math.isfinite(v) for v in la + lb) or not all(
            abs(a - b) <= FX_REL * abs(b) for a, b in zip(la, lb)):
        raise AssertionError(f"torchfx losses {la} vs onnx {lb}")
    return res


def bag_path():
    """(d): the host embedding-bag, native against numpy, sum and mean,
    timed on the host."""
    from flexflow_tpu_torch.native.wrappers import embedding_bag
    rng = np.random.default_rng(6)
    table = rng.standard_normal((BAG_VOCAB, DLRM_DIM), np.float32)
    idx = rng.integers(0, BAG_VOCAB, (BAG_BATCH, BAG_LEN))
    idx[rng.random(idx.shape) < 0.1] = -1
    res = {}
    for mode in ("sum", "mean"):
        times, outs = {}, {}
        for name in ("native", "numpy"):
            with native_off(name == "numpy"):
                embedding_bag(table, idx, mode)
                t0 = time.perf_counter()
                outs[name] = embedding_bag(table, idx, mode)
                times[name] = 1e3 * (time.perf_counter() - t0)
        err = float(np.abs(outs["native"] - outs["numpy"]).max())
        res[mode] = {"max_abs_err": err, "ms": times,
                     "max_abs": max(1.0, float(np.abs(outs["numpy"]).max())),
                     "bitwise": bool((outs["native"] == outs["numpy"]).all())}
    log(f"frontend (d) host embedding_bag, {BAG_BATCH} bags of {BAG_LEN} "
        f"over ({BAG_VOCAB}, {DLRM_DIM}) f32, a tenth padding: native vs "
        f"numpy {res} (ms on the host)")
    for mode, r in res.items():
        if not r["max_abs_err"] <= BAG_REL * r["max_abs"]:
            raise AssertionError(f"embedding_bag {mode}: {r}")
    return res


def frontend_phase(ls, sr, card: str):
    """The frontends (see the module docstring): (a) the Keras LSTM
    classifier, (b) the native loader under fit(prefetch=True), (c)
    torch.fx and ONNX imports of the CIFAR-10 CNN, (d) the host
    embedding-bag. f32, TF32 off (resolve_device)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    res = {"keras": keras_path(ls, sr, card), "loader": loader_path(card),
           "import": import_path(card), "embedding_bag": bag_path()}
    res["phase_s"] = time.perf_counter() - t0
    log(f"frontend phase: {res['phase_s']:.1f} s")
    return res


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

    if "--only-mesh" in sys.argv[1:]:
        log(json.dumps({"mesh": mesh_phase(card)}, default=str))
        return 0
    if "--only-tp-serve" in sys.argv[1:]:
        log(json.dumps({"tp_serve": tp_serve_phase(pr, card)},
                       default=str))
        return 0
    if "--only-pool-tp" in sys.argv[1:]:
        log(json.dumps({"pool_tp": pool_tp_phase(pr, card)}, default=str))
        return 0
    if "--only-sp" in sys.argv[1:]:
        log(json.dumps({"sp": sp_phase(fa, card)}, default=str))
        return 0
    if "--only-pp" in sys.argv[1:]:
        log(json.dumps({"pp": pp_phase(fa, card)}, default=str))
        return 0
    if "--only-channel" in sys.argv[1:]:
        log(json.dumps({"channel": channel_phase(ls, card)}, default=str))
        return 0
    if "--only-layout" in sys.argv[1:]:
        log(json.dumps({"layout": layout_phase(fa, card)}, default=str))
        return 0
    if "--only-frontend" in sys.argv[1:]:
        log(json.dumps({"frontend": frontend_phase(ls, sr, card)},
                       default=str))
        return 0
    kres = kernel_phase(pr)
    dres = paged_decode_phase(fa)
    fres = flash_phase(fa)
    hres = head_dim_phase(fa, pr)
    tres = train_phase(fa, card)
    lmres, lm = lm_train_phase(fa, card)
    lres = lstm_phase(ls)
    nres = nmt_train_phase(ls, card)
    sres = serve_phase(pr, fa, card, lm)
    rres, rlaunches = robust_phase(pr, fa, card, lm)
    tierres, tlaunches = tier_phase(pr, card, lm)
    disres, dlaunches = disagg_phase(pr, card, lm)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    fitres, drop_launches = fit_loop_phase(kd, fa, card)
    dres_f = dropout_phase(kd)
    swres, s2s_launches = sweep_phase(ls, card)
    dlres = dlrm_phase(sr, card)
    moeres = moe_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    searchres = search_phase(fa, ls)
    gc.collect()
    torch.cuda.empty_cache()
    meshres = mesh_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    tpres = tp_serve_phase(pr, card)
    gc.collect()
    torch.cuda.empty_cache()
    ptres = pool_tp_phase(pr, card)
    gc.collect()
    torch.cuda.empty_cache()
    spres = sp_phase(fa, card)
    gc.collect()
    torch.cuda.empty_cache()
    ppres = pp_phase(fa, card)
    gc.collect()
    torch.cuda.empty_cache()
    chres = channel_phase(ls, card)
    gc.collect()
    torch.cuda.empty_cache()
    layres = layout_phase(fa, card)
    gc.collect()
    torch.cuda.empty_cache()
    feres = frontend_phase(ls, sr, card)

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
        "launches": sres["f32"][0]["paged_ragged_v2"],
        "robust_launches": rlaunches["robust_mixed"],
        "tier_launches": tlaunches, "disagg_launches": dlaunches,
        # tp_serve_phase: a rank's launches at t = 2 (its 4 of 8 heads)
        "tp_launches": {"f32": tpres["f32"]["launches"],
                        "int8": tpres["int8"]["launches"],
                        "cluster": tpres["handoff"]["cluster_launches"]},
        # pool_tp_phase (a): a rank's launches in the t = 2 pool over the
        # LM on the host, on the wall clock in lockstep; (c) its shape
        "pool_tp_launches": ptres["launches"],
        "pool_tp_heads": ptres["kernel"],
        **head(kres),
        "bf16": kres["bf16"], "int8": kres["int8"], "fp8": kres["fp8"],
        "tp_heads": tpres["kernel"]}, {
        "name": "paged_decode", "route": "cuda", "source": decode_src,
        "replaces": "flexflow_tpu/kernels/flash_attention.py:390",
        "launches": sres["legacy_f32"][0]["paged_decode"],
        "robust_launches": rlaunches["robust_legacy"],
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
            "robust_fit_launches": rlaunches["robust_fit"][kname],
            "search_launches": {
                k: searchres["calibration"][k]["launches"][kname]
                for k in ("encoder", "lm")},
            "search_measure_launches":
                searchres["grounding"]["launches"][kname],
            "mesh_launches": {
                kind: [r["flash_launches"][kname]
                       for r in meshres[f"b_{kind}"]]
                for kind in ("dp", "tp")},
            # sp_phase (a): a rank's launches through the all-to-all
            # core (4 of 8 heads, the whole sequence), and the ring's
            "sp_launches": {
                key: [r[key]["flash_launches"][kname]
                      for r in spres["lm"]]
                for key in ("float32 alltoall", "bfloat16 alltoall",
                            "float32 ring", "bfloat16 ring")},
            "ulysses": spres["kernels"][kname],
            # pp_phase (a), (b), (e): a rank's launches in the pipelined
            # LM's stages (its attention layers x M microbatches a step)
            # and in the pipeline_blocks stack; (d) the microbatch shape
            "pp_launches": {
                **{key: [r[key]["flash_launches"][kname]
                         for r in ppres["lm"]]
                   for key in ("float32 gpipe", "float32 1f1b",
                               "bfloat16 gpipe", "bfloat16 1f1b",
                               "float32 1f1b v=2")},
                "blocks": [r["flash_launches"][kname]
                           for r in ppres["blocks"]]},
            "pp": ppres["kernels"][kname],
            # layout_phase (a), (b): a rank's launches under the FSDP
            # layout (4 of 8 heads, 8 of 16 rows) and through the
            # all-to-all core over ("seq", "model") (2 of 8 heads, the
            # whole sequence); (c) that per-rank shape
            "layout_launches": {
                **{f"fsdp {d}": [r[f"{d} auto"]["flash_launches"][kname]
                                 for r in layres["fsdp"]]
                   for d in ("float32", "bfloat16")},
                **{f"seq {d} {mo}": [r[f"{d} {mo}"]["flash_launches"][
                    kname] for r in layres["seq"]]
                   for d in ("float32", "bfloat16")
                   for mo in ("alltoall", "ring")}},
            "layout": layres["kernels"][kname],
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
            "search_launches":
                searchres["calibration"]["nmt"]["launches"][kname],
            "search_measure_launches":
                searchres["grounding"]["launches"][kname],
            "seq2seq_shapes": swres["seq2seq"]["lstm_kernels"],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "port_layer_ms": head["port_layer_ms"],
            "device_launches": nres["device_launches"][kname],
            # channel_phase (a): a rank's walks in the split form (one a
            # layer a step) and the device kernels they enqueued (T a
            # forward walk, 2T + 1 a backward walk), f32 and bf16; (c)
            # the split form at the rank's shape
            "channel_launches": {
                d: [r[d]["launches"][kname] for r in chres["nmt"]]
                for d in ("f32", "bf16")},
            "channel_device_launches": {
                d: [r[d]["device_launches"][kname] for r in chres["nmt"]]
                for d in ("f32", "bf16")},
            "split": chres["kernels"][kname],
            # frontend_phase (a): the Keras classifier's captured fit
            # (3 steps) and its predict (2 batches)
            "keras_launches": feres["keras"]["launches"][kname],
            "keras_device_launches":
                feres["keras"]["device_launches"][kname],
            "keras_predict_launches":
                feres["keras"]["predict_launches"][kname],
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
            "mesh_launches": {
                kind: [r["dropout_launches"][kname]
                       for r in meshres[f"b_{kind}"]]
                for kind in ("dp", "tp")},
            # sp_phase (a): on blocks of the sequence (one run a row)
            "sp_launches": {
                key: [r[key]["dropout_launches"][kname]
                      for r in spres["lm"]]
                for key in ("float32 alltoall", "bfloat16 alltoall",
                            "float32 ring", "bfloat16 ring")},
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
        # sp_phase (d): a rank's launches on its placed slots
        "sp_launches": [r["sparse_rows_launches"]["sparse_rows_exact"]
                        for r in spres["dlrm"]],
        # frontend_phase (a): the Keras classifier's embedding rows
        "keras_launches":
            feres["keras"]["sparse_rows_launches"]["sparse_rows_exact"],
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
    log(json.dumps({"robust": rres}))
    log(json.dumps({"tier": tierres}))
    log(json.dumps({"disagg": disres}))
    log(json.dumps({"sweep": swres}))
    log(json.dumps({"search": searchres}, default=str))
    log(json.dumps({"mesh": meshres}, default=str))
    log(json.dumps({"tp_serve": tpres}, default=str))
    log(json.dumps({"pool_tp": ptres}, default=str))
    log(json.dumps({"sp": {k: v for k, v in spres.items()
                           if k != "kernels"}}, default=str))
    log(json.dumps({"pp": {k: v for k, v in ppres.items()
                           if k != "kernels"}}, default=str))
    log(json.dumps({"channel": {k: v for k, v in chres.items()
                                if k != "kernels"}}, default=str))
    log(json.dumps({"layout": {k: v for k, v in layres.items()
                               if k != "kernels"}}, default=str))
    log(json.dumps({"frontend": feres}, default=str))
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
