"""Launch counting shared by the kernel wrappers.

Each wrapper calls :func:`count_launch` where its kernel launches, and
nowhere else: the counts show that a run's main path went through the
kernels. Inside a CUDA graph capture (``core/programs.py``) a launch
does not run: it is enqueued into the graph, which runs it at every
replay. So while a registry captures, the launches are recorded, and
the registry adds each recorded launch to its count at every replay of
that graph (:func:`replay_launches`).
"""

from __future__ import annotations

import torch

# the (table, key, n) launches of the graph being captured, else None
_recording = None


def _bump(table, key, n: int) -> None:
    """Add n to a dict entry, or to a module attribute (``launches`` of
    kernels/paged_ragged_v2.py is a module-level int)."""
    if isinstance(table, dict):
        table[key] += n
    else:
        setattr(table, key, getattr(table, key) + n)


def count_launch(table, key, n: int = 1) -> None:
    """Count n launches of ``table[key]``: now, or at every replay of
    the graph being captured."""
    rec = _recording
    if (rec is not None and torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        rec.append((table, key, n))
    else:
        _bump(table, key, n)


def start_recording() -> list:
    """Begin recording the launches of one capture; returns the list
    they land in."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a capture is already recording launches")
    _recording = []
    return _recording


def stop_recording() -> None:
    global _recording
    _recording = None


def replay_launches(recorded) -> None:
    """Count a replay of a graph whose capture recorded ``recorded``."""
    for table, key, n in recorded:
        _bump(table, key, n)
