"""queue_wait_ms.serve: the mean, over requests admitted in the window,
of the host time from the client's send to the start of the step whose
plan admitted it (the scheduler's queue; ``serve/scheduler.py`` through
``ServeSession.step``)."""


def read(run):
    if run.kind != "serve":
        return None
    v = [r.t_admit - r.t_send for r in run.requests
         if run.in_window(r.t_admit)]
    return 1e3 * sum(v) / len(v) if v else None
