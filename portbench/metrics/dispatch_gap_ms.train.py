"""dispatch_gap_ms.train: the mean host gap between two dispatches of
``fit`` (``model.py`` ``fit``, ``core/overlap.DispatchWindow``), fit's
own ``dispatch_gap_s_mean``, over the window's calls, weighted by the
gaps each call has."""


def read(run):
    if run.kind != "train":
        return None
    calls = [c for c in run.fit_calls if c.steps > 1]
    n = sum(c.steps - 1 for c in calls)
    if not n:
        return None
    return 1e3 * sum(c.gap_s_mean * (c.steps - 1) for c in calls) / n
