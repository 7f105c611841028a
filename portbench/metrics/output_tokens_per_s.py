"""output_tokens_per_s: every output token clients received in the
window, over the window's host-clock length."""


def read(run):
    if run.kind != "serve":
        return None
    return sum(s.emitted for s in run.window_steps()) / run.window_s
