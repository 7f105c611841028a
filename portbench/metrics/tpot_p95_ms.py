"""tpot_p95_ms: the 95th percentile, over every request that finished
in the window with two tokens or more, of (last token - first token) /
(tokens - 1), each token stamped when its client received it."""

import numpy as np


def read(run):
    if run.kind != "serve":
        return None
    v = [(r.t_last - r.t_first) / (r.n_out - 1) for r in run.requests
         if run.in_window(r.t_done) and r.outcome == "completed"
         and r.n_out > 1]
    return 1e3 * float(np.percentile(v, 95)) if v else None
