"""Local rank processes for an executing mesh on one machine.

:class:`RankPool` starts ``world`` processes (``spawn``), each joining
one process group through a ``file://`` rendezvous
(:func:`parallel.mesh.init_distributed`), and runs jobs on all of them
in lockstep: :meth:`RankPool.run` hands every rank the same picklable
function (a module-level function of an importable module) and
arguments and returns the ranks' results in rank order. A rank that
raises fails the call with its traceback; a rank that stops answering
within ``timeout_s`` fails it too, and the pool is then torn down
(its peers may be blocked in a collective). The CPU tests hold the
mesh semantics against JAX with gloo pools, and ``chip_smoke.py`` runs
its two ranks on one card with one. torchrun's environment is the
launcher of a real job; this pool is the in-process counterpart for
tests and the smoke.
"""

from __future__ import annotations

import os
import queue
import traceback
from typing import Any, Callable, List, Optional


def _worker(rank: int, world: int, init_file: str, backend: str,
            device: str, threads: int, jobs, results) -> None:
    import torch
    if threads:
        torch.set_num_threads(threads)
    from .mesh import init_distributed, shutdown_distributed
    try:
        init_distributed(backend=backend,
                         init_method=f"file://{init_file}", rank=rank,
                         world_size=world, device=device)
    except BaseException:
        results.put((rank, "err", traceback.format_exc()))
        return
    results.put((rank, "ok", "ready"))
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args, kw = job
        try:
            out = fn(*args, **kw)
            results.put((rank, "ok", out))
        except BaseException:
            results.put((rank, "err", traceback.format_exc()))
    try:
        shutdown_distributed()
    except Exception:
        pass


class RankPool:
    """``world`` rank processes of one process group (see the module
    docstring). ``device`` is each rank's device: the card unless the
    caller passes "cpu"; ``backend`` as in ``init_distributed`` (gloo on
    the CPU, NCCL on cards of their own, gloo when asked for ranks
    sharing a card); ``threads`` the torch intra-op threads a rank (0:
    torch's default)."""

    def __init__(self, world: int, init_file: str,
                 backend: Optional[str] = None, device: str = "cuda",
                 threads: int = 1,
                 timeout_s: float = 300.0):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        if os.path.exists(init_file):
            os.remove(init_file)
        self.world = world
        self.timeout_s = timeout_s
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._procs = [ctx.Process(
            target=_worker, daemon=True,
            args=(r, world, init_file, backend, device, threads,
                  self._jobs[r], self._results))
            for r in range(world)]
        for p in self._procs:
            p.start()
        try:
            self._collect("starting the ranks")
        except BaseException:
            self.close(force=True)
            raise

    def _collect(self, what: str) -> List[Any]:
        out: List[Any] = [None] * self.world
        errs = []
        timeout = self.timeout_s
        for _ in range(self.world):
            try:
                rank, status, val = self._results.get(timeout=timeout)
            except queue.Empty:
                self.close(force=True)
                raise TimeoutError(
                    f"{what}: a rank gave no answer in {timeout} s (the "
                    f"pool is closed)" + "".join(
                        "\n" + e for e in errs)) from None
            if status == "err":
                errs.append(f"rank {rank}:\n{val}")
                # its peers may be stuck in a collective: wait for them
                # only briefly
                timeout = min(timeout, 20.0)
            out[rank] = val
        if errs:
            raise RuntimeError(f"{what} failed on {len(errs)} rank(s):\n"
                               + "\n".join(errs))
        return out

    def run(self, fn: Callable, *args, **kw) -> List[Any]:
        """``fn(*args, **kw)`` on every rank; the results by rank."""
        for q in self._jobs:
            q.put((fn, args, kw))
        return self._collect(getattr(fn, "__name__", "job"))

    def close(self, force: bool = False) -> None:
        for p, q in zip(getattr(self, "_procs", []), self._jobs):
            if p.is_alive() and not force:
                q.put(None)
        for p in getattr(self, "_procs", []):
            p.join(timeout=0 if force else 30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        self._procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)
