"""mfu.serve: the model flops of the tokens the window's steps computed
(2 a matmul parameter a token, and q.k and p.v over each token's
visible context; padding lanes not counted) over the window's length
at the bf16 peak, in percent."""


def read(run):
    if run.kind != "serve":
        return None
    st = run.window_steps()
    if not st:
        return None
    c, w = run.config, run.work
    per_tok = 2.0 * w.opt_matmul_params(c)
    per_ctx = 4.0 * c["num_hidden_layers"] * c["hidden_size"]
    flops = sum(s.lanes * per_tok + s.lens_sum * per_ctx for s in st)
    return 100.0 * flops / (run.window_s * run.peaks["bf16_flops"])
