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

Not ported: ``save``/``load_warm`` (a CUDA graph cannot be serialized;
the port's config has no program cache directory).
"""

from __future__ import annotations

import gc
import hashlib
import json
import time
from typing import Any, Dict, Sequence

import torch

from ..kernels import _launches


def fingerprint_hash(fp: Dict[str, Any]) -> str:
    """Stable short hash of a fingerprint dict: canonical JSON, then
    sha256 (the JAX registry's)."""
    blob = json.dumps(fp, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _leaf_sig(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), str(x.dtype))
    return ("s", repr(x))


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
                 capture: bool = True):
        self.fingerprint = dict(fingerprint)
        self.fp_hash = fingerprint_hash(fingerprint)
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self._seen: set = set()                    # (family, sig), eager
        self._programs: Dict[tuple, _Program] = {}  # (family, sig)
        self._compiles: Dict[str, int] = {}         # family -> captures
        self._replays: Dict[str, int] = {}
        self._compile_s: Dict[str, float] = {}
        self._stream = None

    # ---------------- registration -------------------------------------
    def register(self, name: str) -> None:
        self._compiles.setdefault(name, 0)
        self._replays.setdefault(name, 0)
        self._compile_s.setdefault(name, 0.0)

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
                self._compiles[name] += 1
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
            self._compiles[name] += 1
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
        self._compiles[name] += 1
        self._compile_s[name] += time.perf_counter() - t0
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

    def boot_record(self) -> Dict[str, Any]:
        """What readying this registry's programs cost."""
        return {
            "fingerprint": self.fp_hash,
            "captured": self.capture,
            "compiles": int(sum(self._compiles.values())),
            "compile_s": float(sum(self._compile_s.values())),
            "families": {n: {"compiles": self._compiles[n],
                             "compile_s": round(self._compile_s[n], 4)}
                         for n in self._compiles},
        }


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
