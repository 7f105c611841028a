"""Checkpoint / resume, crash-safe; counterpart of
``flexflow_tpu/core/checkpoint.py`` in the port's own format.

The JAX package saves with orbax; the card's machine has none, so the
port writes ``torch.save`` of host copies — ``{"params": {op: {name:
tensor}}, "states": {op: {name: tensor}}, "opt_state": {slot: {op:
{name: tensor}}}, "step": int}``, the states being the ops'
non-trainable state (BatchNorm's running statistics) —
as ``state.pt`` inside a checkpoint directory. The crash discipline is
the JAX module's: every save lands in ``<path>.tmp`` and is promoted
onto ``<path>`` with whole-directory renames only once fully written
and synced, so a process killed at any instant leaves the previous
complete checkpoint or none at the final name, never a truncated one;
a kill inside the two-rename window leaves it at ``<path>.old``, which
every reader recovers first (:func:`recover_promoted`). Fault sites
(utils/faults.py): ``ckpt.save`` before a write, ``ckpt.commit``
between the complete write and the promote, ``ckpt.swap`` inside the
rename window.

:class:`AsyncSaver` snapshots the state to host on the calling thread
(so training may go on updating the device tensors in place), writes on
a worker thread, and promotes save N when save N+1 starts or at
``wait_until_finished``/``close``. :func:`restore_model` copies a
checkpoint into the model's tensors in place (a captured step keeps
reading the same memory) and resyncs ``_host_step``, so a resumed run's
dropout stream continues exactly. An INFERENCE-compiled model restores
params and step and skips the optimizer slots.

On an executing mesh (pass the model's ``executor``) every rank takes
part in gathering the global state (``Executor.global_state``), rank 0
alone writes it — the same ``state.pt`` as one device's, so a mesh
checkpoint loads on one device and the reverse — and the other ranks
wait at a barrier after the commit. A restore reads the global file on
every rank and keeps each rank's blocks (``Executor.local_state``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import torch

from ..utils.faults import default_injector
from .executor import TrainState

STATE_FILE = "state.pt"


def _promote(tmp: str, final: str) -> None:
    """Swing ``final`` to the fully-written ``tmp`` directory with
    whole-directory renames (see the module docstring)."""
    old = final + ".old"
    if os.path.isdir(old) and os.path.isdir(final):
        shutil.rmtree(old)      # stale leftover from a killed promote
    if os.path.isdir(final):
        os.rename(final, old)
    # the narrow not-atomic window: final is absent, the previous
    # checkpoint complete at .old, the new one complete at tmp
    default_injector().fire("ckpt.swap")
    os.rename(tmp, final)
    if os.path.isdir(old):
        shutil.rmtree(old)


def recover_promoted(path: str) -> None:
    """Heal a promote killed inside its rename window: if nothing is
    committed at ``path`` but a complete previous checkpoint sits at
    ``<path>.old``, swing it back. Idempotent; every reader calls it."""
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        os.rename(path + ".old", path)


def _host_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return {k: _host_tree(v) for k, v in tree.items()}


def _payload(state: TrainState, executor=None) -> dict:
    """Host copies of the state (a device-to-host copy synchronizes, so
    the snapshot is complete when this returns); on a mesh the global
    state, gathered from every rank."""
    if _on_mesh(executor):
        g = executor.global_state(state)
        return {"params": _host_tree(g["params"]),
                "states": _host_tree(g["states"]),
                "opt_state": _host_tree(g["opt_state"]),
                "step": g["step"]}
    return {"params": _host_tree(state.params),
            "states": _host_tree(state.states),
            "opt_state": _host_tree(state.opt_state),
            "step": int(state.step)}


def _on_mesh(executor) -> bool:
    return executor is not None and getattr(executor, "bm", None) is not None


def _writer(executor) -> bool:
    """Whether this rank writes: rank 0 of a mesh, or the one device."""
    return not _on_mesh(executor) or executor.bm.rank == 0


def _barrier(executor) -> None:
    if _on_mesh(executor):
        from ..parallel.collectives import barrier
        barrier(executor.bm)


def _write(tmp: str, payload: dict) -> None:
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)      # an uncommitted leftover of a killed save
    os.makedirs(tmp)
    fname = os.path.join(tmp, STATE_FILE)
    with open(fname, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())


class AsyncSaver:
    """Saves written on a worker thread, promoted lazily: save N is
    promoted when save N+1 starts or at wait_until_finished()/close().
    Until then it is invisible at its final path — the crash contract
    of the synchronous save, stretched over the worker."""

    def __init__(self, executor=None):
        self._pending: Optional[tuple] = None
        self.executor = executor

    def save(self, path: str, state: TrainState) -> None:
        self._commit_pending()
        path = os.path.abspath(path)
        default_injector().fire("ckpt.save")
        payload = _payload(state, self.executor)   # snapshot here
        if not _writer(self.executor):
            self._pending = (None, path, None, [])
            return
        err: list = []

        def work():
            try:
                _write(path + ".tmp", payload)
            except BaseException as e:      # surfaced at the commit
                err.append(e)

        worker = threading.Thread(target=work, daemon=True,
                                  name="ff-checkpoint-writer")
        worker.start()
        self._pending = (path + ".tmp", path, worker, err)

    def _commit_pending(self) -> None:
        if self._pending is None:
            return
        tmp, final, worker, err = self._pending
        self._pending = None
        if worker is not None:
            worker.join()
            if err:
                raise err[0]
            # the staged kill point: tmp is complete, final not yet swung
            default_injector().fire("ckpt.commit")
            _promote(tmp, final)
        _barrier(self.executor)

    def wait_until_finished(self) -> None:
        self._commit_pending()

    def close(self) -> None:
        self._commit_pending()


def save_checkpoint(path: str, state: TrainState, use_async: bool = False,
                    checkpointer=None, executor=None):
    """Save a TrainState to ``path`` (a directory), atomically. With
    ``use_async`` the write runs on a worker and an :class:`AsyncSaver`
    is returned: keep it and call ``wait_until_finished()`` (or
    ``close()``) before relying on the checkpoint; pass it back as
    ``checkpointer`` to reuse it. ``executor``: the model's, for a
    state on an executing mesh (every rank calls this)."""
    if use_async:
        saver = (checkpointer if checkpointer is not None
                 else AsyncSaver(executor))
        saver.save(path, state)
        return saver
    path = os.path.abspath(path)
    default_injector().fire("ckpt.save")
    payload = _payload(state, executor)
    if _writer(executor):
        _write(path + ".tmp", payload)
        # the staged kill point: tmp is complete, path not yet swung
        default_injector().fire("ckpt.commit")
        _promote(path + ".tmp", path)
    _barrier(executor)
    return None


def atomic_write_json(path: str, obj, fault_site: str = "ckpt.commit"
                      ) -> None:
    """temp-then-``os.replace`` JSON write: ``path`` holds the previous
    complete content or the new one, never a truncation."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    default_injector().fire(fault_site)
    os.replace(tmp, path)


def _like(saved, template, what: str):
    """``saved`` laid out as ``template`` (a tree of tensors): the same
    keys and shapes, each leaf on the template's device and dtype."""
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) \
                or tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint {what}: "
                             f"{getattr(saved, 'shape', type(saved))} does "
                             f"not match {tuple(template.shape)}")
        return saved.to(device=template.device, dtype=template.dtype)
    if not isinstance(saved, dict) or set(saved) != set(template):
        raise ValueError(f"checkpoint {what}: keys differ from the model's")
    return {k: _like(saved[k], template[k], f"{what}.{k}")
            for k in template}


def restore_checkpoint(path: str, state: TrainState,
                       executor=None) -> TrainState:
    """A new TrainState with ``state``'s structure, devices and dtypes,
    read from ``path``. An INFERENCE-compiled model (``opt_state ==
    {}``) reads params and step only, skipping the on-disk slots. On a
    mesh (``executor``) each rank keeps its blocks of the global
    file."""
    path = os.path.abspath(path)
    if _writer(executor):
        recover_promoted(path)
    _barrier(executor)
    payload = torch.load(os.path.join(path, STATE_FILE),
                         map_location="cpu", weights_only=True)
    if _on_mesh(executor):
        payload = executor.local_state(payload)
    params = _like(payload["params"], state.params, "params")
    states = _like(payload.get("states", {}), state.states, "states")
    opt = (_like(payload["opt_state"], state.opt_state, "opt_state")
           if state.opt_state else {})
    for op, p in params.items():
        for k, w in p.items():
            w.requires_grad_(state.params[op][k].requires_grad)
    return TrainState(params, opt, int(payload["step"]), states)


def save_model(model, path: str, use_async: bool = False):
    """Returns the AsyncSaver when ``use_async`` (see save_checkpoint),
    else None."""
    return save_checkpoint(path, model.state, use_async=use_async,
                           executor=model.executor)


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        with torch.no_grad():
            dst.copy_(src)
        return
    for k in dst:
        _copy_into(dst[k], src[k])


def restore_model(model, path: str) -> None:
    """Restore ``path`` into the model's tensors IN PLACE and resync the
    per-step key mirror (``_host_step``) from the restored step."""
    restored = restore_checkpoint(path, model.state, model.executor)
    _copy_into(model.state.params, restored.params)
    _copy_into(model.state.states, restored.states)
    if model.state.opt_state:
        _copy_into(model.state.opt_state, restored.opt_state)
    model.state.step = restored.step
    model._host_step = int(restored.step)
