"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library at first use, then bound with
``ctypes`` — no PyTorch headers, so a build takes seconds. The
library's file name carries a digest of the source, the shared headers,
the flags and the compiler's version string, so an edited source or
another toolkit rebuilds and a stale library is never loaded.
:func:`build` compiles several sources in parallel (one ``nvcc``
process each, all started together), each through a temporary file
that is renamed into place, with a checksum sidecar beside it.

Where the libraries live: ``flexflow_tpu_torch/_build/`` inside the
checkout, unless :func:`arm_cache` pointed the process at a kernel
cache (``FFConfig.program_cache_dir``'s ``<dir>/kernels``; the
counterpart of JAX's persistent compilation cache in ``<dir>/xla``):
there a library built once is loaded by every later process over the
same sources and toolkit. Arming takes effect once per process, for the
first directory asked for (two engines over different directories must
not move a process-wide location under each other), and never reloads
a library already bound.

A library that fails to load, or whose bytes no longer match its
checksum, is deleted and rebuilt from the source in the checkout with a
warning (a bad cache costs a build, never a wrong kernel); a build that
fails raises with the compiler's output. Neither falls back to a
kernel's plain version. :func:`build_counts`, :func:`cache_hits` and
:func:`build_seconds` count this process's compiler runs and cache
loads (the registry's boot record reads them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNEL_SOURCES = ("paged_ragged_v2", "flash_attention", "paged_decode",
                  "lstm_scan", "dropout", "sparse_rows")
# the armed kernel cache's subdirectory of a program cache directory
CACHE_SUBDIR = "kernels"

_LIBS: Dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()
_cache_dir: Optional[Path] = None          # <dir>/kernels once armed
_versions: Dict[str, str] = {}             # compiler path -> --version
_builds: Dict[str, int] = {}               # compiler runs, per library
_build_s = [0.0]                           # wall seconds in builds
_hits: Dict[str, int] = {}                 # loads of a cached library


# ------------------------------------------------------------ the cache
def arm_cache(cache_dir) -> bool:
    """Resolve every library under ``<cache_dir>/kernels`` from now on,
    once per process: the first call wins, and a later call with
    another directory changes nothing and returns False (True when the
    cache is, or already was, armed at this directory). Libraries
    already bound stay bound."""
    global _cache_dir
    want = Path(cache_dir).resolve() / CACHE_SUBDIR
    with _lock:
        if _cache_dir is None:
            _cache_dir = want
        return _cache_dir == want


def library_dir() -> Path:
    """Where libraries resolve: the armed cache, else ``_build/``."""
    return _cache_dir if _cache_dir is not None else BUILD_DIR


def compiler_version(path: str) -> str:
    """The compiler's ``--version`` output (read once a compiler);
    raises when it does not run."""
    v = _versions.get(path)
    if v is None:
        p = subprocess.run([path, "--version"], capture_output=True,
                           text=True)
        if p.returncode != 0:
            raise RuntimeError(f"{path} --version failed:\n"
                               f"{p.stdout}{p.stderr}")
        v = _versions[path] = p.stdout.strip()
    return v


# ------------------------------------------------------------ counters
def record_build(names: Sequence[str], seconds: float) -> None:
    """Count one compiler run for each library of ``names``, run
    together in ``seconds`` of wall time."""
    for name in names:
        _builds[name] = _builds.get(name, 0) + 1
    _build_s[0] += float(seconds)


def record_hit(name: str) -> None:
    """Count one load of a cached library this process did not build."""
    _hits[name] = _hits.get(name, 0) + 1


def build_counts() -> Dict[str, int]:
    """Compiler runs in this process, per library (the CUDA sources by
    name, the native library as ``native``)."""
    return dict(_builds)


def cache_hits() -> Dict[str, int]:
    """Libraries this process loaded from the armed cache without
    building them, per library."""
    return dict(_hits)


def build_seconds() -> float:
    """Wall seconds this process spent in compiler runs."""
    return _build_s[0]


# ------------------------------------------------------------ checksums
def _checksum_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".sha256")


def _file_sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def install(tmp: Path, final: Path) -> None:
    """Move a freshly built library into place: its checksum sidecar
    first, then the library itself, each by an atomic rename, so a
    reader never sees a half-written library."""
    side = _checksum_path(final)
    side_tmp = side.with_name(f"{side.name}.{os.getpid()}."
                              f"{threading.get_ident()}.tmp")
    side_tmp.write_text(_file_sha(tmp))
    os.replace(side_tmp, side)
    os.replace(tmp, final)


def verified(path: Path) -> bool:
    """Whether a library's bytes match the checksum written at its
    build (a missing sidecar does not match)."""
    side = _checksum_path(path)
    try:
        return side.read_text().strip() == _file_sha(path)
    except OSError:
        return False


def discard(path: Path) -> None:
    """Delete a library and its checksum."""
    path.unlink(missing_ok=True)
    _checksum_path(path).unlink(missing_ok=True)


def load_verified(name: str, path: Path, rebuild) -> ctypes.CDLL:
    """``ctypes.CDLL`` of a library that ``rebuild()`` built (or found)
    at ``path``; a library that fails its checksum or does not load is
    deleted and rebuilt once with a warning (never replaced by a plain
    version). Counts a cache hit when this process never built it."""
    rebuild()
    try:
        if not verified(path):
            raise OSError("its checksum does not match its bytes")
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        warnings.warn(f"kernel library {path} failed to load ({e}); "
                      f"deleted and rebuilt from the source",
                      stacklevel=3)
        discard(path)
        rebuild()
        lib = ctypes.CDLL(str(path))
    if not _builds.get(name) and _cache_dir is not None:
        record_hit(name)
    return lib


# ------------------------------------------------------------ CUDA
def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else $PATH, else CUDA's default install
    prefix. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_digest(name: str) -> str:
    """Digest of ``csrc/<name>.cu``, the shared headers (``csrc/*.cuh``)
    and the flags: what a program store keys on (no compiler needed)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    return hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]


def _nvcc_version() -> str:
    """nvcc's version string; empty where there is no nvcc (nothing can
    be built at that path then, and the build raises)."""
    try:
        return compiler_version(nvcc_path())
    except RuntimeError:
        return ""


def library_path(name: str) -> Path:
    """The library's path; its digest covers the source, the shared
    headers, the flags and nvcc's version string."""
    digest = hashlib.sha256((source_digest(name) + "\n"
                             + _nvcc_version()).encode())
    return library_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, all in
    parallel. Returns {name: nvcc's output} for the sources it built
    (``-Xptxas=-v`` puts each kernel's registers and spills there).
    Raises with the compiler's output when any build fails."""
    with _lock:
        todo = [n for n in names if not library_path(n).is_file()]
        if not todo:
            return {}
        library_dir().mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs, failed = {}, []
        for n, (tmp, p) in procs.items():
            logs[n] = p.communicate()[0]
            if p.returncode != 0:
                failed.append(n)
                tmp.unlink(missing_ok=True)
            else:
                install(tmp, library_path(n))   # never half-built
        record_build(todo, time.perf_counter() - t0)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + ":\n" + "\n".join(logs[n] for n in failed))
        return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _lock:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = load_verified(
                    name, library_path(name), lambda: build([name]))
    return lib
