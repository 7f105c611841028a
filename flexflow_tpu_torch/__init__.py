"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

The JAX package ``flexflow_tpu`` is the reference; this package imports
neither it nor JAX. It serves and trains on one NVIDIA H100:

  * serving: the causal LM of ``build_transformer_lm`` (an FFModel)
    through the chunked mixed step on f32, bf16, int8 or fp8 KV pages,
    with attention in a hand-written CUDA kernel
    (``kernels/csrc/paged_ragged_v2.cu``), and through the legacy bucket
    path with the paged decode kernel (``kernels/csrc/paged_decode.cu``);
  * training the Transformer encoder of ``build_transformer`` and the
    causal LM of ``build_transformer_lm`` through ``FFModel.compile`` /
    ``train_batch`` / ``fit`` / ``evaluate``, under the JAX
    mixed-precision policy, with attention forward and backward in
    hand-written CUDA kernels (``kernels/csrc/flash_attention.cu``);
  * training the NMT LSTM of ``build_nmt_lstm`` and the encoder-decoder
    of ``build_nmt_seq2seq`` through the same ``FFModel``, with the LSTM
    recurrence forward and backward in hand-written CUDA kernels
    (``kernels/csrc/lstm_scan.cu``);
  * training the conv and MLP models of the JAX package's sweep —
    ``build_alexnet``, ``build_resnet``, ``build_inception_v3`` and
    ``build_candle_uno`` — with Conv2D, Pool2D, BatchNorm (running
    statistics as op state), Flat and the small ops, under
    ``conv_layout`` NCHW or NHWC (channels_last) and sibling-conv
    fusion;
  * the JAX package's single-device training loop: multi-step and
    accumulated dispatches, a prefetching loader (``core/dataloader.py``),
    crash-safe checkpoints (``core/checkpoint.py``), remat, the runtime
    learning rate, and dropout drawn from JAX's own key stream
    (``core/prng.py``) by a hand-written kernel
    (``kernels/csrc/dropout.cu``);
  * DLRM (``build_dlrm``, separate or stacked tables) with the JAX
    executor's sparse embedding updates, the touched rows updated in a
    hand-written kernel (``kernels/csrc/sparse_rows.cu``), and the MoE
    ops and models (``build_moe_reference``, ``build_moe_fused``);
  * serving and training under failure and under telemetry: injected
    faults retried at the dispatch boundary, cancels, deadlines, crash
    containment and post-mortem bundles in the engine, the JAX
    package's telemetry bus, metrics and reports (``utils/``), and
    ``fit``'s dispatch window (``core/overlap.py``);
  * the strategy search (``search/``, ``parallel/``, ``native/``):
    models priced on descriptions of machines of any size, strategies
    searched in a Python and a native C++ engine, exported, explained,
    and grounded on the card (op measurement, calibrated steps, fit's
    drift samples);
  * meshes that execute, one process a rank on ``torch.distributed``
    (``parallel/``): data, tensor, sequence and expert parallelism,
    placed tables, tensor-parallel serving, and pipelines — pinned or
    auto-cut stages under GPipe, 1F1B and interleaved schedules
    (``core/staged.py``) and stacked blocks (``ops/pipeline.py``).

Every serving and training step is one program of a registry
(``core/programs.py``): on the card it is captured once as a CUDA graph
and replayed. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from .config import (CompMode, FFConfig, FFIterationConfig,
                     ParameterSyncType, resolve_device)
from .core.optimizers import AdamOptimizer, SGDOptimizer
from .model import FFModel
from .models import (build_alexnet, build_candle_uno, build_dlrm,
                     build_inception_v3, build_moe_fused,
                     build_moe_reference, build_nmt_lstm, build_nmt_seq2seq,
                     build_resnet)
from .models.transformer import (LMArch, TransformerLM, build_transformer,
                                 build_transformer_lm)
from .serve import ServeEngine
from .tensor import Parameter, Tensor
from .weights import from_jax_params, load_jax_params

__all__ = ["CompMode", "FFConfig", "FFIterationConfig", "ParameterSyncType",
           "resolve_device",
           "FFModel", "Tensor", "Parameter", "SGDOptimizer",
           "AdamOptimizer", "LMArch", "TransformerLM", "build_alexnet",
           "build_candle_uno", "build_dlrm", "build_inception_v3",
           "build_moe_fused", "build_moe_reference", "build_nmt_lstm",
           "build_nmt_seq2seq", "build_resnet",
           "build_transformer", "build_transformer_lm", "ServeEngine",
           "from_jax_params", "load_jax_params"]
