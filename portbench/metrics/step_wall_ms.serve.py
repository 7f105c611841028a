"""step_wall_ms.serve: the window's host-clock length over its steps
(``ServeSession.step``, the host's planning and packing included)."""


def read(run):
    if run.kind != "serve":
        return None
    st = run.window_steps()
    return 1e3 * run.window_s / len(st) if st else None
