"""train_tokens_per_s: the tokens of every training step completed in
the window (batch x sequence a step), over the window's host-clock
length; the window ends when the last ``fit`` call returns, drained."""


def read(run):
    if run.kind != "train":
        return None
    steps = sum(c.steps for c in run.fit_calls)
    return steps * run.batch * run.seq / run.window_s
