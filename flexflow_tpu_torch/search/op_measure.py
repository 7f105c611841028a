"""Per-op, per-shape measured costs for the strategy search;
counterpart of ``flexflow_tpu/search/op_measure.py``, whole, on the
card.

The analytic roofline prices op families, not shapes. This module
grounds the top-N ops (``FFConfig.measure_top_ops``) in measurements on
the H100: each op alone at its data-sharded sub-shape, its forward,
then forward and backward through ``torch.autograd``, each timed with
CUDA events around single calls after a synchronize, the median of
``repeats`` kept. The simulator then replaces those ops' analytic
fwd/bwd with the measured seconds (search/simulator.py
``measured_adjust``). An op whose forward runs a hand-written kernel
must launch it while it is measured — the attention op the flash
kernels (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``), the LSTM
op the recurrence kernels (``lstm_fwd``, ``lstm_bwd``) — and
``measure_op`` raises if the launch counters (kernels/_launches.py)
did not move.

Results are memoized in-process and kept on disk per card identity
(name and power limit, ``search/measure.card_identity``) under the
git-ignored ``flexflow_tpu_torch/_build/`` (``FLEXFLOW_TORCH_CACHE``
overrides). ``op_signature`` names what a measurement depends on, in
the JAX package's spelling (dtypes by their JAX names). On a host
without CUDA ``measure_op`` and ``conv_in_situ_factor`` raise: they
measure the card or nothing. Unlike the JAX module, an op that fails
while it is measured raises too: a failing kernel is not priced
analytically behind the caller's back.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.precision import dtype_name
from ..op import Op, OpContext

# (card identity, signature) -> {"fwd": s, "bwd": s}
_MEMO: Dict[Tuple[str, str], Dict[str, float]] = {}
_DISK_LOADED: set = set()


def _cache_path(identity: str) -> str:
    from .measure import cache_file
    return cache_file("op_costs", identity)


def _load_disk(identity: str) -> None:
    if identity in _DISK_LOADED:
        return
    _DISK_LOADED.add(identity)
    try:
        with open(_cache_path(identity)) as f:
            for sig, v in json.load(f).items():
                _MEMO[(identity, sig)] = v
    except (OSError, json.JSONDecodeError):
        pass


def _persist(identity: str) -> None:
    path = _cache_path(identity)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = {sig: v for (ident, sig), v in _MEMO.items()
                if ident == identity and v is not None}
        with open(path, "w") as f:
            json.dump(data, f)
    except OSError:
        pass  # an unwritable cache must not abort a search


def op_signature(op: Op, sample_shard: int) -> str:
    """Hashable measurement key: what the kernels see — op type, input
    shapes/dtypes at the sharded batch, weight shapes, and the attrs
    that change the computation (the JAX package's string)."""
    ins = []
    for t in op.inputs:
        shape = list(t.shape)
        if shape and shape[0] % sample_shard == 0:
            shape[0] //= sample_shard
        ins.append((tuple(shape), dtype_name(t.dtype)))
    ws = sorted((w, tuple(s.shape), dtype_name(s.dtype))
                for w, s in op.weight_specs().items())
    attrs = sorted((k, str(v)) for k, v in
                   getattr(op, "attrs", {}).items())
    return json.dumps([op.op_type, ins, ws, attrs])


def kernel_counters(op: Op, seq_length: int = -1):
    """(launch table, kernel names) of the hand-written kernels the op
    runs on the card at this ``seq_length``, or (None, ()) for an op
    that runs none."""
    if op.op_type == "multihead_attention" and op.uses_flash(seq_length):
        from ..kernels import flash_attention as fa
        return fa.launches, fa.FLASH_KERNELS
    if op.op_type == "lstm" and op.use_pallas is not False:
        from ..kernels import lstm_scan
        return lstm_scan.launches, ("lstm_fwd", "lstm_bwd")
    return None, ()


def _median_ms(torch, fn, repeats: int) -> float:
    """Median device milliseconds of one ``fn()`` call over ``repeats``
    calls, each between two CUDA events, after a warm call and a
    synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(max(1, repeats)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _card(torch):
    """The card the measurements run on (the current CUDA device)."""
    return torch.device("cuda", torch.cuda.current_device())


def measure_op(op: Op, sample_shard: int = 1, repeats: int = 10,
               seq_length: int = -1) -> Optional[Dict[str, float]]:
    """Time ``op`` alone on the card at its data-sharded sub-shape: its
    training-mode forward, and forward plus backward by
    ``torch.autograd.grad`` of the outputs' f32 sum with respect to the
    weights and the float inputs (integer inputs are ids). Returns
    {"fwd": s, "bwd": s} (bwd = the backward-only increment, at least a
    fifth of the forward). Memoized per (card identity, signature).
    Raises without a card, when the op fails, and when an op that runs
    a hand-written kernel did not launch it."""
    from .measure import _cuda, card_identity
    torch = _cuda()
    ident = card_identity()
    _load_disk(ident)
    sig = op_signature(op, sample_shard)
    if (ident, sig) in _MEMO:
        return _MEMO[(ident, sig)]

    from ..core import prng
    from ..core.executor import _stable_hash
    from ..core.prng import OpRng

    dev = _card(torch)

    def sub(shape):
        shape = list(shape)
        if shape and shape[0] % sample_shard == 0:
            shape[0] //= sample_shard
        return tuple(shape)

    xs = []
    float_idx = []
    for i, t in enumerate(op.inputs):
        if t.dtype.is_floating_point:
            xs.append(torch.full(sub(t.shape), 0.01, dtype=t.dtype,
                                 device=dev))
            float_idx.append(i)
        else:
            xs.append(torch.zeros(sub(t.shape), dtype=t.dtype, device=dev))
    params = {w: torch.full(spec.shape, 0.01, dtype=spec.dtype, device=dev)
              for w, spec in op.weight_specs().items()}
    # stateful ops (BatchNorm's running statistics) read ctx.state_in
    state_in = {name: torch.full(spec.shape, spec.init_value,
                                 dtype=spec.dtype, device=dev)
                for name, spec in op.state_specs().items()}
    key = torch.as_tensor(prng.key_words(prng.prng_key(0)), device=dev)
    rng = OpRng(key, _stable_hash(op.name))

    def ctx():
        return OpContext(training=True, rng=rng, seq_length=seq_length,
                         state_in=state_in)

    def fwd():
        with torch.no_grad():
            return op.forward(params, xs, ctx())

    diff = list(params.values()) + [xs[i] for i in float_idx]
    for v in diff:
        v.requires_grad_(True)

    def fwd_bwd():
        ys = op.forward(params, xs, ctx())
        loss = sum(y.float().sum() for y in ys if y.is_floating_point())
        return torch.autograd.grad(loss, diff, allow_unused=True)

    table, names = kernel_counters(op, seq_length)
    before = {k: table[k] for k in names} if table is not None else {}
    t_fwd = _median_ms(torch, fwd, repeats) * 1e-3
    if diff:
        t_both = _median_ms(torch, fwd_bwd, repeats) * 1e-3
    else:
        t_both = 2.0 * t_fwd  # nothing to differentiate: estimate
    if table is not None:
        idle = [k for k in names if table[k] == before[k]]
        if idle:
            raise RuntimeError(
                f"measure_op({op.name}): the op's kernels {idle} did not "
                f"launch while it was measured")
    res = {"fwd": t_fwd, "bwd": max(t_both - t_fwd, 0.2 * t_fwd)}
    _MEMO[(ident, sig)] = res
    _persist(ident)
    return res


# op types corrected by the conv-chain in-situ factor: the families
# whose isolated measurements under-predict their cost inside a graph
CONV_CHAIN_TYPES = ("conv2d", "pool2d", "batch_norm")

_INSITU: Dict[str, float] = {}


def conv_in_situ_factor() -> float:
    """Isolated->in-situ correction for conv-chain ops, measured once
    per card identity and kept on disk: one real train step of a fixed
    small conv-chain graph (device time, CUDA events, less the per-step
    dispatch overhead) over the sum of its ops' isolated measurements
    (the same ``measure_op`` the simulator grounds with). Clamped to
    [1, 3]. Raises without a card."""
    from .measure import _cuda, card_identity
    _cuda()
    ident = card_identity()
    if ident in _INSITU:
        return _INSITU[ident]
    path = _insitu_path(ident)
    try:
        with open(path) as f:
            _INSITU[ident] = _clamp_insitu(float(json.load(f)["factor"]))
        return _INSITU[ident]
    except (OSError, json.JSONDecodeError, KeyError, ValueError,
            TypeError):
        pass
    factor = _measure_insitu_factor()
    if factor is None:
        _INSITU[ident] = 1.0   # in-process only, never persisted
        return 1.0
    factor = _clamp_insitu(factor)
    _INSITU[ident] = factor
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"factor": factor}, f)
    except OSError:
        pass
    return factor


def _clamp_insitu(f: float) -> float:
    if not np.isfinite(f):
        return 1.0
    return float(min(3.0, max(1.0, f)))


def _insitu_path(identity: str) -> str:
    from .measure import cache_file
    return cache_file("insitu", identity)


def _measure_insitu_factor() -> Optional[float]:
    """The JAX package's micro-graph (conv, batch norm, strided conv,
    pool, dense head at 149 px, batch 8), trained on the card; None
    when its step time is not above the dispatch overhead."""
    from .measure import _cuda, measure_step_overhead
    torch = _cuda()

    from ..config import FFConfig
    from ..core.optimizers import SGDOptimizer
    from ..model import FFModel

    size = 149
    cfg = FFConfig(batch_size=8, sibling_conv_fusion=False)
    ff = FFModel(cfg)
    x = ff.create_tensor((8, 16, size, size), name="input")
    t = ff.conv2d(x, 32, 3, 3, 1, 1, 1, 1, name="ins_c0")
    t = ff.batch_norm(t, name="ins_bn0")
    t = ff.conv2d(t, 64, 3, 3, 2, 2, 1, 1, activation="relu",
                  name="ins_c1")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="ins_p0")
    t = ff.flat(t, name="ins_flat")
    t = ff.dense(t, 10, name="ins_head")
    ff.softmax(t, name="ins_sm")
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type="sparse_categorical_crossentropy", metrics=[])
    rng = np.random.RandomState(0)
    batch = ff.executor.shard_batch(
        {"input": rng.randn(8, 16, size, size).astype(np.float32),
         "label": rng.randint(0, 10, (8,)).astype(np.int32)})
    reps = 10
    real = _median_ms(torch, lambda: ff.train_batch(batch), reps) * 1e-3
    real = max(0.0, real - measure_step_overhead(repeats=reps))
    isolated = 0.0
    for op in ff.ops:
        r = measure_op(op)
        isolated += r["fwd"] + r["bwd"]
    if isolated <= 0 or real <= 0:
        return None
    return real / isolated


def clear_memo() -> None:
    _MEMO.clear()
    _DISK_LOADED.clear()
    _INSITU.clear()
