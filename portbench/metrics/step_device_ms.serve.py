"""step_device_ms.serve: device-busy milliseconds a step in the traced
sub-window (the captured mixed step, ``ServeEngine._mixed_body``,
replayed by ``core/programs.py``), from the profiler's trace."""


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    n = len(run.traced_steps())
    return 1e3 * run.trace.busy_s / n if n else None
