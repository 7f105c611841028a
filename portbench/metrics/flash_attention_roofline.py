"""flash_attention_roofline: kernels 2-4's (``kernels/flash_attention.py``,
``csrc/flash_attention.cu``: forward, dq, dk/dv) share of their
roofline in the traced steps, in percent: each launch's least time
(the larger of its flops at the bf16 peak and its bytes at the HBM
peak, from the frozen ``flash_work`` at the step's causal shape),
summed over the three kernels' traced launches, over their summed
traced device time."""

from portbench.harness.kernel_classes import FLASH


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    c, w = run.config, run.work
    heads = c["num_attention_heads"]
    work = w.flash_work(run.batch, run.seq, run.seq, heads,
                        c["hidden_size"] // heads, 2, True)
    bound = sec = 0.0
    for name, pat in FLASH.items():
        s, n = run.trace.kernel_seconds(pat)
        sec += s
        bound += n * w.roofline_seconds(*work[name], run.peaks)
    return 100.0 * bound / sec if sec > 0 else None
