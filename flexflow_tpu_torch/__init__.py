"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

The JAX package ``flexflow_tpu`` is the reference; this package imports
neither it nor JAX. Its first slice serves the causal LM of
``build_transformer_lm`` through the chunked mixed step on an NVIDIA
H100, with attention in a hand-written CUDA kernel
(``kernels/csrc/paged_ragged_v2.cu``). Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

from .config import FFConfig, resolve_device
from .models.transformer import LMArch, TransformerLM, build_transformer_lm
from .serve import ServeEngine
from .weights import from_jax_params

__all__ = ["FFConfig", "resolve_device", "LMArch", "TransformerLM",
           "build_transformer_lm", "ServeEngine", "from_jax_params"]
