"""mfu.train: the model flops of the window's training steps (6 a matmul
parameter a token, and 6 * L * E * S a token for causal attention;
recomputation not counted) over the window's length at the bf16 peak,
in percent."""


def read(run):
    if run.kind != "train":
        return None
    steps = sum(c.steps for c in run.fit_calls)
    flops = steps * run.work.opt_train_step_flops(run.config, run.batch,
                                                  run.seq)
    return 100.0 * flops / (run.window_s * run.peaks["bf16_flops"])
