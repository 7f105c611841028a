"""What the port's CUDA wrappers and its kernel build module do on the
host, checked on the CPU: the bf16 flash forward's alignment rule, and
the build digest that must change with every source a library is
compiled from."""

import re

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.kernels import _build
from flexflow_tpu_torch.kernels import flash_attention as fa


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The port's CPU computations here run at test shapes, and beside
    other test workers on one host each worker's intra-op thread pool
    oversubscribes the cores (a serving case that takes 2 s alone took
    25 s beside two other workers). One thread for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
        .bfloat16()


def test_rows_aligned16_keeps_aligned_operands():
    x = _bf16((2, 40, 3, 64))
    assert x.data_ptr() % 16 == 0
    assert fa._rows_aligned16(x) is x
    # a fused-projection view: strides are multiples of 8, rows aligned
    k = _bf16((2, 40, 3, 3, 64))[:, :, 1]
    assert not k.is_contiguous()
    assert fa._rows_aligned16(k) is k


@pytest.mark.parametrize("kind", ["s_stride", "offset"])
def test_rows_aligned16_copies_unaligned_operands(kind):
    if kind == "s_stride":       # rows of a (b, s, h*d + 4) buffer
        x = _bf16((2, 40, 3 * 64 + 4))[..., :3 * 64].unflatten(-1, (3, 64))
        assert x.stride(1) % 8 != 0
    else:                        # contiguous, but starting 2 bytes in
        flat = _bf16((2 * 40 * 3 * 64 + 1,))
        x = flat[1:].view(2, 40, 3, 64)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    y = fa._rows_aligned16(x)
    assert y.data_ptr() % 16 == 0 and y.is_contiguous()
    assert all(s % 8 == 0 for s in y.stride()[:3])
    assert torch.equal(y, x)


def test_library_digest_covers_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first          # deterministic
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build.library_path("k")
    assert second != first                            # header edit rebuilds
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)


@pytest.mark.parametrize("name", _build.KERNEL_SOURCES)
def test_kernel_sources_include_only_shipped_headers(name):
    """Every quoted #include of a kernel source is a file of csrc/, so a
    checkout builds it (and the digest above covers it)."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for inc in re.findall(r'#include\s+"([^"]+)"', src):
        assert (_build.CSRC / inc).is_file(), inc
        assert inc.endswith(".cuh"), inc
