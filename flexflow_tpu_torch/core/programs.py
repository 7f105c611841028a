"""ProgramRegistry: one captured CUDA graph per program family and
argument signature; counterpart of ``flexflow_tpu/core/programs.py``.

The JAX registry resolves (family, argument signature) to an AOT
compiled executable and counts every compile exactly: after warm-up the
counts must never grow (the zero-recompile contract). Here the
counterpart of a compile is a capture:

- ``register(name)`` declares a family (the engine's ``mixed``,
  ``decode`` and ``prefill``, the executor's ``train_step``,
  ``train_step_multi``, ``train_step_accum`` and ``eval_step_multi``);
  ``call`` registers one at its first call, as the JAX registry does.
- ``call(name, fn, *args)`` on CUDA: the first call of a (family,
  signature) pair copies the arguments into static device buffers, runs
  ``fn`` eagerly once on the registry's side stream — that run is the
  call's own work and the warm-up PyTorch needs before a capture (it
  builds the kernels and creates the library handles and workspaces on
  the stream the capture then uses) — and captures ``fn`` once with
  ``torch.cuda.graph``, counted exactly per family. Every later call
  copies the new arguments into the static buffers, replays the graph
  and returns the graph's static outputs, which the next call of the
  same program overwrites. A capture that fails raises; nothing stays
  eager quietly.
- On the CPU (the caller chose it) and with ``capture=False`` (the
  eager reference runs of the tests and the smoke) the registry counts
  signatures the same way and runs ``fn`` eagerly.
- ``call_eager`` always runs eagerly and counts the same way: the
  serving engine's in-place adapter loads and page export/import.
- On an executing mesh under NCCL a train step with its collectives is
  one program as on one device: the gradient buckets' hooks run during
  the capture (their all-reduces issued on a communication stream
  forked from the capture stream and joined before the update), and a
  replay runs the captured NCCL all-reduces; the collectives' launch
  counts are recorded like the kernels'. A gloo mesh on the card
  stages its collectives through host memory and cannot be captured:
  its steps run with ``capture=False``. The signature counts are the
  local batch's shapes, one count a signature as on one device, equal
  to JAX's ``compile_counts()`` on the same mesh.

Arguments are tensors, whose shape and dtype key the signature (a
pinned host tensor fills its device buffer with one asynchronous copy),
or other values, which key it by value and are baked into the graph.
A graph also bakes in the addresses of every tensor its body reads
(parameters, pages, optimizer slots): a caller passes those as
``bound=``, and a replay raises if one moved since the capture.

The warm boot (``cache_dir=``, ``FFConfig.program_cache_dir``): JAX
serializes its compiled executables; a CUDA graph cannot be serialized,
so here a store is data, not code. ``save()`` writes every signature
this registry ran to ``<dir>/<fp_hash>.ffprog`` — JSON: the store
version, the fingerprint and its hash, the torch and CUDA versions and
the device name, and per entry its family, its signature (the argument
recipe: each tensor's shape and dtype, each static argument's value)
and its capture seconds — through a temporary file and a rename,
merged with a valid store already there, beside a ``manifest.json``.
``load_warm()`` reads the store back: each entry is a signature known
at boot (``restored_counts()``), which the owner readies before its
first request (the serving engine's ``warmup`` captures every one).
Those captures still count in ``compile_counts()``: JAX's warm contract
is zero compiles, the port's is that no compiler ran at the boot (the
kernel-library cache, ``kernels/_build.py``), that every restored
signature was readied, and that nothing is captured after it
(``boot_record()["warm"]``). A corrupt, truncated or foreign store
warns (or misses) and boots cold; it never raises.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..kernels import _build, _launches

STORE_VERSION = 1
STORE_SUFFIX = ".ffprog"


def fingerprint_hash(fp: Dict[str, Any]) -> str:
    """Stable short hash of a fingerprint dict: canonical JSON, then
    sha256 (the JAX registry's)."""
    blob = json.dumps(fp, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _leaf_sig(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), str(x.dtype))
    return ("s", repr(x))


def runtime_identity(device) -> Dict[str, str]:
    """What the stored programs were run on: the torch and CUDA
    versions and the device's name (folded into every fingerprint)."""
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return {"torch": torch.__version__,
            "cuda": str(torch.version.cuda), "device_name": name}


def _sig_to_json(sig: tuple) -> list:
    return [list(leaf) if leaf[0] == "s"
            else ["t", list(leaf[1]), leaf[2]] for leaf in sig]


def _sig_from_json(doc) -> tuple:
    out = []
    for leaf in doc:
        if leaf[0] == "s" and len(leaf) == 2 and isinstance(leaf[1], str):
            out.append(("s", leaf[1]))
        elif (leaf[0] == "t" and len(leaf) == 3
              and all(isinstance(n, int) for n in leaf[1])
              and isinstance(leaf[2], str)):
            out.append(("t", tuple(leaf[1]), leaf[2]))
        else:
            raise ValueError(f"malformed signature leaf {leaf!r}")
    return tuple(out)


def _tensors(tree):
    """The tensors of a returned value (a tensor, or tuples, lists and
    dicts of them)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


class _Program:
    __slots__ = ("graph", "static_in", "static_out", "launches", "ptrs")

    def __init__(self, graph, static_in, static_out, launches, ptrs):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches
        self.ptrs = ptrs


class ProgramRegistry:
    """Signatures, capture counting and replay for a set of named
    program families (one registry per engine or executor)."""

    def __init__(self, fingerprint: Dict[str, Any], device,
                 capture: bool = True, cache_dir: Optional[str] = None):
        self.fingerprint = dict(fingerprint)
        self.fp_hash = fingerprint_hash(fingerprint)
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self.cache_dir = cache_dir
        self._seen: set = set()                    # (family, sig), eager
        self._programs: Dict[tuple, _Program] = {}  # (family, sig)
        self._compiles: Dict[str, int] = {}         # family -> captures
        self._replays: Dict[str, int] = {}
        self._compile_s: Dict[str, float] = {}
        self._stream = None
        # the warm boot: every signature run (for save), its capture
        # seconds, and the signatures a store restored
        self._ran: Dict[tuple, float] = {}          # (family, sig) -> s
        self._restored: Dict[str, int] = {}
        self._restored_keys: set = set()
        self._dirty = False
        # the compiler runs before this registry existed: a boot's own
        # are the ones after (kernels/_build.py counts them)
        self._builds0 = sum(_build.build_counts().values())
        self._build_s0 = _build.build_seconds()
        if cache_dir:
            _build.arm_cache(cache_dir)

    # ---------------- registration -------------------------------------
    def register(self, name: str) -> None:
        self._compiles.setdefault(name, 0)
        self._replays.setdefault(name, 0)
        self._compile_s.setdefault(name, 0.0)
        self._restored.setdefault(name, 0)

    def families(self) -> tuple:
        return tuple(self._compiles)

    def _first_call(self, key, seconds: float) -> None:
        """Count a new (family, signature) and remember it for save
        (a store that restored it holds it already)."""
        self._compiles[key[0]] += 1
        self._ran[key] = seconds
        if key not in self._restored_keys:
            self._dirty = True

    @staticmethod
    def signature(args: Sequence) -> tuple:
        return tuple(_leaf_sig(a) for a in args)

    # ---------------- dispatch -----------------------------------------
    def call(self, name: str, fn, *args, bound: Sequence = ()):
        """Run ``fn(*args)`` as the program of (name, signature):
        eagerly on the CPU or with capture off, else captured on the
        first call and replayed after. ``bound`` lists the tensors the
        body reads besides its arguments."""
        if name not in self._compiles:
            self.register(name)
        key = (name, self.signature(args))
        if not self.capture:
            if key not in self._seen:
                self._seen.add(key)
                self._first_call(key, 0.0)
            if self.device.type == "cuda":
                args = tuple(a.to(self.device, non_blocking=True)
                             if isinstance(a, torch.Tensor) else a
                             for a in args)
            return fn(*args)
        prog = self._programs.get(key)
        if prog is None:
            return self._capture(name, key, fn, args, bound)
        ptrs = tuple(t.data_ptr() for t in bound)
        if ptrs != prog.ptrs:
            raise RuntimeError(
                f"program {name!r}: a tensor its captured graph reads "
                f"has moved since the capture (a parameter or page was "
                f"rebound, not updated in place); the graph would read "
                f"stale memory")
        for s, a in zip(prog.static_in, args):
            if isinstance(a, torch.Tensor):
                s.copy_(a, non_blocking=True)
        prog.graph.replay()
        self._replays[name] += 1
        _launches.replay_launches(prog.launches)
        return prog.static_out

    def call_eager(self, name: str, fn, *args):
        """Run ``fn(*args)`` eagerly on the current stream, counted
        like a capture (one per new signature): the programs that
        write device state in place between steps and must not be
        replayed from static buffers (the engine's adapter slot loads
        and page imports, and the exports beside them)."""
        if name not in self._compiles:
            self.register(name)
        key = (name, self.signature(args))
        if key not in self._seen:
            self._seen.add(key)
            self._first_call(key, 0.0)
        return fn(*args)

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _capture(self, name, key, fn, args, bound):
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        static_in = []
        for a in args:
            if isinstance(a, torch.Tensor):
                s = torch.empty(a.shape, dtype=a.dtype, device=self.device)
                s.copy_(a, non_blocking=True)
                static_in.append(s)
            else:
                static_in.append(a)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*static_in)            # this call's own run
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: one there can run the
        # finalizers of an unreachable earlier model (its graphs and their
        # private memory pools), whose CUDA calls invalidate the capture;
        # torch.cuda.graph no longer collects on entry by default
        gc_was_on = gc.isenabled()
        gc.disable()
        recorded = _launches.start_recording()
        try:
            # thread_local: this thread's unsafe CUDA calls still fail the
            # capture, but another thread's (the prefetching loader's
            # allocations, pinned slots and event waits on its own
            # stream) may run while it is underway
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                static_out = fn(*static_in)
        except Exception as e:
            raise RuntimeError(
                f"capturing program {name!r} as a CUDA graph failed: "
                f"{e}") from e
        finally:
            _launches.stop_recording()
            if gc_was_on:
                gc.enable()
        cur.wait_stream(side)
        for t in _tensors(out):             # made on the side stream
            t.record_stream(cur)
        self._programs[key] = _Program(
            graph, static_in, static_out, recorded,
            tuple(t.data_ptr() for t in bound))
        secs = time.perf_counter() - t0
        self._first_call(key, secs)
        self._compile_s[name] += secs
        return out

    def release(self, families: Sequence[str] = None) -> None:
        """Drop the captured graphs (each holds a private memory pool)
        and static buffers of ``families``, every family when None;
        later calls of them capture anew."""
        keep = (lambda k: False) if families is None \
            else (lambda k: k[0] not in families)
        self._programs = {k: p for k, p in self._programs.items()
                          if keep(k)}
        self._seen = {k for k in self._seen if keep(k)}

    # ---------------- accounting ---------------------------------------
    def compile_counts(self) -> Dict[str, int]:
        """Captures (on the CPU or eager: new signatures) per registered
        family, exact."""
        return dict(self._compiles)

    def replay_counts(self) -> Dict[str, int]:
        """Replays per family: a kernel in a family's graph launched
        once a replay, besides the capturing call's own run."""
        return dict(self._replays)

    def restored_counts(self) -> Dict[str, int]:
        """Signatures per family that a store restored at boot."""
        return dict(self._restored)

    def compile_seconds(self) -> float:
        """Seconds spent capturing (the runs that captured included)."""
        return float(sum(self._compile_s.values()))

    def _readied(self, key) -> bool:
        return key in self._programs or key in self._seen

    def pending_restored(self) -> List[tuple]:
        """(family, signature) of every restored signature not run yet:
        what a warm boot still has to ready."""
        return sorted(k for k in self._restored_keys
                      if not self._readied(k))

    def boot_record(self) -> Dict[str, Any]:
        """What readying this registry's programs cost: captures and
        their seconds, the signatures a store restored, the compiler
        runs (kernel and native libraries) since the registry was made,
        and ``warm`` — no compiler ran, a store restored signatures, and
        every one of them was readied."""
        builds = sum(_build.build_counts().values()) - self._builds0
        restored = int(sum(self._restored.values()))
        capture_s = self.compile_seconds()
        return {
            "fingerprint": self.fp_hash,
            "captured": self.capture,
            "compiles": int(sum(self._compiles.values())),
            "compile_s": capture_s,
            "capture_s": capture_s,
            "restored": restored,
            "builds": int(builds),
            "build_s": _build.build_seconds() - self._build_s0,
            "warm": bool(builds == 0 and restored > 0
                         and not self.pending_restored()),
            "families": {n: {"compiles": self._compiles[n],
                             "restored": self._restored.get(n, 0),
                             "compile_s": round(self._compile_s[n], 4)}
                         for n in self._compiles},
        }

    # ---------------- the warm boot's store -----------------------------
    @property
    def dirty(self) -> bool:
        """Whether signatures ran that the store does not hold yet."""
        return self._dirty

    def _store_path(self, cache_dir: Optional[str] = None) -> str:
        d = cache_dir if cache_dir is not None else self.cache_dir
        return os.path.join(d, self.fp_hash + STORE_SUFFIX)

    def save(self, cache_dir: Optional[str] = None) -> int:
        """Write every signature this registry ran to
        ``<dir>/<fp_hash>.ffprog`` (JSON, a temporary file then an
        atomic rename), merged with a valid store already there (two
        engines over one directory each add theirs), and update
        ``manifest.json``. Returns the entries written (0 when no
        directory is armed)."""
        d = cache_dir if cache_dir is not None else self.cache_dir
        if not d:
            return 0
        os.makedirs(d, exist_ok=True)
        path = self._store_path(d)
        entries: Dict[tuple, dict] = {}
        old = self._read_store(path)
        for e in (old or {}).get("entries", []):
            entries[(e["family"], _sig_from_json(e["sig"]))] = e
        for (family, sig), secs in self._ran.items():
            entries[(family, sig)] = {
                "family": family, "sig": _sig_to_json(sig),
                "capture_s": float(secs)}
        doc = {"version": STORE_VERSION, "fingerprint": self.fingerprint,
               "fp_hash": self.fp_hash, **runtime_identity(self.device),
               "entries": list(entries.values())}
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._write_manifest(d, entries)
        self._dirty = False
        return len(entries)

    def _write_manifest(self, d: str, entries: Dict[tuple, dict]) -> None:
        """Best-effort human-readable index of the directory: each
        fingerprint's entries, families and runtime."""
        path = os.path.join(d, "manifest.json")
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                doc = {}
        except (OSError, ValueError):
            doc = {}
        doc[self.fp_hash] = {
            "entries": len(entries),
            "families": sorted({f for f, _ in entries}),
            **runtime_identity(self.device),
            "fingerprint": {k: str(v) for k, v in self.fingerprint.items()},
        }
        try:
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass

    def _read_store(self, path: str) -> Optional[dict]:
        """Read and check a store. A corrupt, truncated or malformed one
        warns and returns None (the caller boots cold); one of another
        fingerprint is a miss (None, no warning)."""
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                doc = json.load(f)
            if (not isinstance(doc, dict)
                    or doc.get("version") != STORE_VERSION
                    or not isinstance(doc.get("entries"), list)):
                raise ValueError("malformed program store")
            if doc.get("fp_hash") != self.fp_hash:
                return None
            for e in doc["entries"]:
                if not (isinstance(e, dict)
                        and isinstance(e.get("family"), str)
                        and isinstance(e.get("sig"), list)):
                    raise ValueError("malformed program store entry")
                _sig_from_json(e["sig"])
        except Exception as e:
            warnings.warn(f"program cache: unreadable store {path!r} "
                          f"({e}); booting cold", stacklevel=3)
            return None
        return doc

    def load_warm(self, cache_dir: Optional[str] = None) -> int:
        """Restore the stored signatures of this fingerprint: each is
        then known at boot (``restored_counts()``,
        :meth:`pending_restored`) until it is run. Returns the number
        restored (0 on a miss or a bad store; never raises)."""
        d = cache_dir if cache_dir is not None else self.cache_dir
        if not d:
            return 0
        doc = self._read_store(self._store_path(d))
        if doc is None:
            return 0
        n = 0
        for e in doc["entries"]:
            key = (e["family"], _sig_from_json(e["sig"]))
            if key in self._restored_keys:
                continue
            self.register(key[0])
            self._restored_keys.add(key)
            self._restored[key[0]] += 1
            n += 1
        return n

    @classmethod
    def load(cls, cache_dir: str, fingerprint: Dict[str, Any],
             device="cpu", capture: bool = True) -> "ProgramRegistry":
        """A registry for ``fingerprint`` warmed from ``cache_dir`` in
        one step (the cold replica's boot)."""
        reg = cls(fingerprint, device, capture=capture, cache_dir=cache_dir)
        reg.load_warm()
        return reg


class PinnedRing:
    """Pinned host staging buffers reused in turn: a slot is rewritten
    only after the device copied out of it (an event recorded after the
    copy), so the host never overwrites what a queued copy still reads.
    On the CPU the slots are plain tensors."""

    def __init__(self, device, depth: int = 2):
        self.device = torch.device(device)
        self._slots = [None] * depth
        self._events = [None] * depth
        self._i = 0

    def take(self, numel: int, dtype) -> torch.Tensor:
        """A 1-d host buffer of ``numel`` ``dtype`` elements, free to
        write."""
        i = self._i = (self._i + 1) % len(self._slots)
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        buf = self._slots[i]
        nbytes = numel * dtype.itemsize
        if buf is None or buf.numel() < nbytes:
            buf = self._slots[i] = torch.empty(
                nbytes, dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        return buf[:nbytes].view(dtype)

    def consumed(self) -> None:
        """Mark the last taken slot as read by the copies queued so
        far on the current stream."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._events[self._i] = ev
