"""Kernel-name patterns of the device trace.

``CLASSES`` is a frozen copy of the classes of
``tools/torch_serve_profile.py`` (first match wins); the benchmark's
breakdown reads it, so a later change to the tool cannot move it.
``KERNEL1`` and ``FLASH`` pick out the port's hand-written kernels by
their ``__global__`` names in ``flexflow_tpu_torch/kernels/csrc``:
``paged_ragged_v2.cu`` launches a plan kernel and a tile kernel for
each call of kernel 1; ``flash_attention.cu`` the forward (kernel 2),
dq (kernel 3) and dk/dv (kernel 4) kernels, each in a scalar and an
``_mma`` form.
"""

import re

CLASSES = (
    ("attention", re.compile(r"ragged_v2_\w*kernel|paged_decode_\w*kernel")),
    ("matmul", re.compile(r"gemm|matmul|sm90_|cutlass|cublas", re.I)),
    ("topk", re.compile(r"topk|sort|radix|argmax|reduce_kernel.*max",
                        re.I)),
    ("kv_scatter", re.compile(r"index_put|indexing|scatter", re.I)),
    ("copy", re.compile(r"memcpy|memset|copy", re.I)),
)

KERNEL1 = re.compile(r"ragged_v2_\w*kernel")
FLASH = {
    "flash_fwd": re.compile(r"flash_fwd_(mma_)?kernel"),
    "flash_bwd_dq": re.compile(r"flash_bwd_dq_(mma_)?kernel"),
    "flash_bwd_dkv": re.compile(r"flash_bwd_dkv_(mma_)?kernel"),
}


def classify(name: str) -> str:
    for cls, pat in CLASSES:
        if pat.search(name):
            return cls
    return "other"
