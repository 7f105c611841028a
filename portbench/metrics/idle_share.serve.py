"""idle_share.serve: the share of the traced sub-window in which no
operation ran on the device, in percent."""


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
