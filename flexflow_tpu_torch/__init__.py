"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

The JAX package ``flexflow_tpu`` is the reference; this package imports
neither it nor JAX. Two slices are ported, both on one NVIDIA H100:

  * serving: the causal LM of ``build_transformer_lm`` through the
    chunked mixed step, with attention in a hand-written CUDA kernel
    (``kernels/csrc/paged_ragged_v2.cu``);
  * training: the Transformer encoder of ``build_transformer`` through
    ``FFModel.compile`` / ``train_batch`` / ``fit`` / ``evaluate``, with
    attention forward and backward in hand-written CUDA kernels
    (``kernels/csrc/flash_attention.cu``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .config import FFConfig, resolve_device
from .core.optimizers import AdamOptimizer, SGDOptimizer
from .model import FFModel
from .models.transformer import (LMArch, TransformerLM, build_transformer,
                                 build_transformer_lm)
from .serve import ServeEngine
from .weights import from_jax_params, load_jax_params

__all__ = ["FFConfig", "resolve_device", "FFModel", "SGDOptimizer",
           "AdamOptimizer", "LMArch", "TransformerLM", "build_transformer",
           "build_transformer_lm", "ServeEngine", "from_jax_params",
           "load_jax_params"]
