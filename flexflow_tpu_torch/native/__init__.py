"""The port's native library, bound with ctypes: the search engine (the
C++ task-graph simulator and MCMC annealing loop, ``simulator.cc``,
``mcmc.cc``, ``sim_core.h``) and the data pipeline's prefetching row
gatherer and host embedding-bag (``dataloader.cc``,
``embedding_bag.cc``), all declared in ``flexflow_torch_c.h`` under
``flexflow_tpu_torch/csrc/``.

The library is compiled with g++ at first use into the git-ignored
``flexflow_tpu_torch/_build/``, as ``kernels/_build.py`` builds the CUDA
sources: its file name carries a digest of the sources and the flags,
so an edited source rebuilds and a stale library is never loaded, and
the build writes a temporary file and renames it, so concurrent
builders never load a half-written library. It reads only
``flexflow_tpu_torch/csrc/``.

A failed build raises with g++'s message: neither the search nor the
loader falls through to its Python path behind the caller's back.
Setting ``FLEXFLOW_TORCH_NO_NATIVE`` turns the library off
(:func:`available` is then False): ``search.mcmc.optimize`` anneals in
Python, ``DataLoaderSet`` gathers rows in Python and
``wrappers.embedding_bag`` reduces in numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("simulator.cc", "mcmc.cc", "dataloader.cc", "embedding_bag.cc")
HEADERS = ("flexflow_torch_c.h", "sim_core.h")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """The library's path; its digest covers the sources, the headers
    and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for f in SOURCES + HEADERS:
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"libflexflow_torch_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the shared library (if it is missing)
    and return its path. Raises with g++'s output when the build
    fails."""
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "the native library needs g++ to build "
            "flexflow_tpu_torch/csrc (set FLEXFLOW_TORCH_NO_NATIVE to "
            "search and load data in Python)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-I", str(CSRC),
           *(str(CSRC / s) for s in SOURCES), "-o", str(tmp), "-lpthread"]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed to build the native library "
            f"({' '.join(cmd)}):\n{p.stdout}{p.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)

    lib.ffsim_simulate.restype = ctypes.c_double
    lib.ffsim_simulate.argtypes = [ctypes.c_int32, f64p, i32p, i32p, i32p]

    lib.ffsearch_mcmc.restype = ctypes.c_double
    lib.ffsearch_mcmc.argtypes = [
        ctypes.c_int32, i32p, i32p,
        f64p, f64p, f64p, f64p, f64p, f64p,
        i32p, i32p, i32p, i32p, f64p, f64p, f64p, ctypes.c_int32,
        ctypes.c_int32, i32p, i32p, i32p, i32p,
        ctypes.c_int32, ctypes.c_double, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, i32p, i32p]

    lib.ffsearch_simulate_assignment.restype = ctypes.c_double
    lib.ffsearch_simulate_assignment.argtypes = [
        ctypes.c_int32, i32p,
        f64p, f64p, f64p, f64p, f64p, f64p,
        i32p, i32p, i32p, i32p, f64p, f64p, f64p, ctypes.c_int32,
        ctypes.c_int32, i32p, i32p,
        ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, i32p]

    i64p = ctypes.POINTER(ctypes.c_int64)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    lib.ffdl_create.restype = ctypes.c_void_p
    lib.ffdl_create.argtypes = [ctypes.c_int32, vpp, i64p,
                                ctypes.c_int64, ctypes.c_int32,
                                ctypes.c_int32]
    lib.ffdl_start_epoch.restype = None
    lib.ffdl_start_epoch.argtypes = [ctypes.c_void_p, i64p]
    lib.ffdl_num_batches.restype = ctypes.c_int32
    lib.ffdl_num_batches.argtypes = [ctypes.c_void_p]
    lib.ffdl_next_batch.restype = ctypes.c_int32
    lib.ffdl_next_batch.argtypes = [ctypes.c_void_p, vpp, i32p]
    lib.ffdl_destroy.restype = None
    lib.ffdl_destroy.argtypes = [ctypes.c_void_p]

    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ffdl_embedding_bag.restype = None
    lib.ffdl_embedding_bag.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int32, i64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, f32p]

    lib.flexflow_torch_native_version.restype = ctypes.c_char_p
    lib.flexflow_torch_native_version.argtypes = []


def get_lib() -> ctypes.CDLL:
    """The native library, built first if needed. Raises when
    FLEXFLOW_TORCH_NO_NATIVE is set or the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    if not available():
        raise RuntimeError(
            "the native library is turned off "
            "(FLEXFLOW_TORCH_NO_NATIVE)")
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library is on (the search's engine, the
    loader's gatherer, the embedding-bag): True unless
    FLEXFLOW_TORCH_NO_NATIVE is set. It does not try the build — a
    build that fails raises when the library is first used."""
    return not os.environ.get("FLEXFLOW_TORCH_NO_NATIVE")
