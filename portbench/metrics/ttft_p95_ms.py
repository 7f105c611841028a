"""ttft_p95_ms: the 95th percentile, over every request whose first
token reached its client in the window, of the time from the client's
send to that token. Failed requests have no first token and count in
``failed`` instead."""

import numpy as np


def read(run):
    if run.kind != "serve":
        return None
    v = [r.t_first - r.t_send for r in run.requests
         if run.in_window(r.t_first)]
    return 1e3 * float(np.percentile(v, 95)) if v else None
