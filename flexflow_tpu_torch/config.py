"""Configuration of the PyTorch/CUDA port, and its device policy.

``FFConfig`` carries the fields of ``flexflow_tpu/config.py`` that the
port's slices read, under the same names and defaults, so one set of
knobs sizes both packages: the serving fields of the serving slice and
the training fields of the training slice, and the mixed-precision
policy of ``core/precision.py``, ``remat`` and
``iter_config.seq_length``, and the conv knobs ``conv_layout`` and
``sibling_conv_fusion``. A few knobs the port does not run yet
(search, pipelines, fusion, telemetry) are here at their JAX
defaults so that setting one reaches ``FFModel.compile``, which raises
``NotImplementedError`` instead of ignoring it. The rest of the JAX
config has no counterpart yet.

Device policy: every entry point runs on the card unless the caller
asks for the CPU. There is no fallback — :func:`resolve_device` raises
when CUDA is asked for and missing.
"""

from __future__ import annotations

import dataclasses

import torch

from .core.precision import resolve_dtype

# the ONE --kv-dtype allowlist (flexflow_tpu/config.py KV_DTYPES); the
# port's engine serves all four (int8/float8_e4m3 on the mixed step only)
KV_DTYPES = ("float32", "bfloat16", "int8", "float8_e4m3")


class CompMode:
    """Computation mode of ``FFModel.compile``: INFERENCE builds the
    parameters without optimizer slots (what a serving engine compiles
    a model with) and refuses to train."""

    TRAINING = "training"
    INFERENCE = "inference"


@dataclasses.dataclass
class FFIterationConfig:
    """Per-iteration runtime config: ``seq_length`` >= 0 masks the
    attention keys (and BatchMatmul's marked dims) at and past it."""

    seq_length: int = -1


@dataclasses.dataclass
class FFConfig:
    """The serving and training knobs of ``flexflow_tpu.config.FFConfig``."""

    # training (model.py fit/compile, core/executor.py init_state)
    batch_size: int = 64
    epochs: int = 1
    learning_rate: float = 0.01
    seed: int = 0
    # master dtype of float parameters and optimizer state (the
    # mixed-precision policy, core/precision.py)
    param_dtype: torch.dtype = torch.float32
    # embedding-table updates. The port updates tables densely through
    # autograd, which is the function of both settings of the JAX
    # sparse_embedding_updates switch (with plain SGD its sparse update
    # is "exact", the dense update restricted to the touched rows; the
    # other optimizers stay dense unless lazy), so it has no such
    # switch. The lazy rule (stale optimizer slots on untouched rows)
    # is not ported: FFModel.compile raises when it is asked for
    sparse_embedding_lazy: bool = False

    # dtype the step computes in: params and float inputs are cast to
    # it inside the differentiated region, losses and metrics score
    # f32-upcast logits (core/precision.py); build_transformer_lm also
    # wires it into the embeddings' output dtype, the served LM's
    # activation dtype
    compute_dtype: torch.dtype = torch.float32

    # block-paged KV-cache geometry (serve/kv_cache.py): page 0 is the
    # write sink for padding lanes
    kv_page_size: int = 16
    kv_num_pages: int = 257
    kv_dtype: str = "float32"
    # size the pool by byte budget instead of page count (0 = use
    # kv_num_pages)
    kv_pool_mb: float = 0.0

    # continuous-batching scheduler caps and the mixed-step geometry
    # (serve_prefill_budget + serve_max_seqs lanes)
    serve_max_seqs: int = 8
    serve_prefill_budget: int = 512
    serve_chunked_prefill: bool = True
    serve_prefix_cache: bool = True
    serve_admit_watermark: float = 0.02

    # speculative decoding (serve/speculative.py)
    serve_spec_decode: bool = True
    serve_spec_tokens: int = 4

    # tuning knob of the ragged paged-attention kernel: KV tokens per
    # work item in the JAX package, any value >= 0; the port maps it
    # onto the keys of the kernel's K/V tile (0 = the kernel's default;
    # kernels/paged_ragged_v2.py _tile_for). It changes no result
    serve_attn_block_kv: int = 0

    # serving knobs of the JAX package the port does not run yet, at
    # their JAX defaults; ServeEngine raises NotImplementedError for any
    # other value: the tensor-parallel serve mesh and LoRA adapters
    serve_mesh: str = ""
    adapter_rank: int = 0

    # graceful-degradation ladder (serve/scheduler.py)
    serve_degrade_ladder: bool = True
    serve_reject_stalls: int = 0

    # recompute each weighted op's activations in the backward
    # (torch.utils.checkpoint), as the JAX executor's jax.checkpoint
    remat: bool = False
    # run sibling convs (one input, one geometry: Inception's 1x1
    # branch heads) as one conv (core/fusion.py)
    sibling_conv_fusion: bool = True
    # "NHWC": conv, pool and batch-norm values stay in channels_last
    # memory between those ops (core/executor.py); shapes stay NCHW
    conv_layout: str = "NCHW"
    # knobs of the JAX package the port does not run yet, at their JAX
    # defaults; FFModel.compile raises NotImplementedError for any other
    # value
    search_budget: int = 0
    pipeline_stages: int = 0
    perform_fusion: bool = False
    telemetry: bool = False
    iter_config: FFIterationConfig = dataclasses.field(
        default_factory=FFIterationConfig)

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Normalize the precision policy to torch dtypes (names such
        as "bfloat16" are taken) and reject values a step would
        silently ignore. Called at construction and from compile."""
        self.compute_dtype = resolve_dtype(self.compute_dtype,
                                           "compute_dtype")
        self.param_dtype = resolve_dtype(self.param_dtype, "param_dtype")
        if self.batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1, got {self.batch_size}")
        if self.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")
        if self.kv_page_size < 1:
            raise ValueError(
                f"kv_page_size must be >= 1, got {self.kv_page_size}")
        if self.kv_num_pages < 2:
            raise ValueError(
                f"kv_num_pages must be >= 2 (page 0 is the serving "
                f"sink page), got {self.kv_num_pages}")
        if self.conv_layout not in ("NCHW", "NHWC"):
            raise ValueError(
                f"conv_layout must be 'NCHW' or 'NHWC', got "
                f"{self.conv_layout!r}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, "
                f"got {self.kv_dtype!r}")
        if self.kv_pool_mb < 0:
            raise ValueError(
                f"kv_pool_mb must be >= 0 (0 = size by kv_num_pages), "
                f"got {self.kv_pool_mb}")
        if self.serve_attn_block_kv < 0:
            raise ValueError(
                f"serve_attn_block_kv must be >= 0 (0 = default), "
                f"got {self.serve_attn_block_kv}")
        if self.serve_max_seqs < 1:
            raise ValueError(
                f"serve_max_seqs must be >= 1, got {self.serve_max_seqs}")
        if self.serve_prefill_budget < 1:
            raise ValueError(
                f"serve_prefill_budget must be >= 1, got "
                f"{self.serve_prefill_budget}")
        if not 0.0 <= self.serve_admit_watermark < 1.0:
            raise ValueError(
                f"serve_admit_watermark must be in [0, 1), got "
                f"{self.serve_admit_watermark}")
        if self.serve_spec_tokens < 0:
            raise ValueError(
                f"serve_spec_tokens must be >= 0 (0 disables "
                f"speculative decoding), got {self.serve_spec_tokens}")
        if self.serve_reject_stalls < 0:
            raise ValueError(
                f"serve_reject_stalls must be >= 0 (0 = never), got "
                f"{self.serve_reject_stalls}")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asked
    for the CPU. Raises when CUDA is asked for and absent — a run on
    the CPU is only ever one the caller chose.

    On CUDA this also turns TF32 off for float32 matmuls and
    convolutions, mirroring the JAX package's float32 matmul precision
    (``jax_default_matmul_precision=float32`` in its tests): an f32
    engine computes in full f32, so its tokens are comparable with the
    reference's. It also keeps bf16 matmul reductions in f32
    (``allow_bf16_reduced_precision_reduction`` off), the JAX ops'
    ``preferred_element_type=float32``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for but CUDA is not available "
                f"(pass device='cpu' to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul \
            .allow_bf16_reduced_precision_reduction = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
