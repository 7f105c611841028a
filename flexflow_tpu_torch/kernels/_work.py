"""The work of the hand-written kernels, for the cost analyses.

``utils/profiling.hlo_cost`` and ``ServeEngine.mixed_step_cost_analysis``
count one step's flops and bytes by running it once eagerly under a
``torch`` dispatch-mode counter. A kernel's launch is a ``ctypes`` call
that no dispatch mode sees, and on the CPU a wrapper runs the kernel's
plain version, whose ops are not the kernel's work. So each wrapper's
dispatch runs inside :func:`kernel`: while a counter is active it adds
the kernel's own count, worked out from its launch arguments by the
count function beside the wrapper (``paged_work``, ``flash_work``,
``lstm_work``, ``lstm_split_work``, ``dropout_work``, ``rows_work``),
and pauses the counter over the body, whichever device runs it. The
same count functions give ``chip_smoke.py``'s bounds: one count of a
kernel's work.

A counter also silences the launch counts (``_launches.count_launch``):
a cost analysis's eager run is not a launch of the main path.
"""

from __future__ import annotations

import contextlib

# the active counter (utils/profiling.StepCost), else None
_counter = None


def active():
    """The counter a cost analysis is running, or None."""
    return _counter


def activate(counter) -> None:
    global _counter
    if counter is not None and _counter is not None:
        raise RuntimeError("a cost analysis is already counting")
    _counter = counter


@contextlib.contextmanager
def kernel(name: str, work):
    """Run a kernel wrapper's body; under an active counter add
    ``work()`` — (bytes, flops) of the kernel on these arguments — as
    the kernel ``name``'s, and count none of the body's own ops."""
    c = _counter
    if c is None:
        yield
        return
    nbytes, flops = work()
    c.add_kernel(name, nbytes, flops)
    with c.paused():
        yield
