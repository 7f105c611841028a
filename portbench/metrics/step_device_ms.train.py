"""step_device_ms.train: device-busy milliseconds a training step in the
traced ``fit`` calls (the captured ``train_step`` of
``core/executor.py``), from the profiler's trace."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    n = sum(c.steps for c in run.fit_calls if c.traced)
    return 1e3 * run.trace.busy_s / n if n else None
