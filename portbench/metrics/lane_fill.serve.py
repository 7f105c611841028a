"""lane_fill.serve: lanes computed (prefill and decode tokens) over
steps x the mixed step's width, in the window, in percent: the share of
each fixed-width step the scheduler filled."""


def read(run):
    if run.kind != "serve":
        return None
    st = run.window_steps()
    if not st:
        return None
    return 100.0 * sum(s.lanes for s in st) / (len(st) * run.mixed_width)
