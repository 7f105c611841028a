"""paged_ragged_v2_roofline: kernel 1's (``kernels/paged_ragged_v2.py``,
``csrc/paged_ragged_v2.cu``: its plan and tile kernels) share of its
roofline in the traced steps, in percent: the least time the chip
could take for every call (the larger of its flops at the bf16 peak
and its bytes at the HBM peak, counted from each step's lanes by the
frozen ``paged_work``; one call a layer a step) over the kernels'
traced device time."""

from portbench.harness.kernel_classes import KERNEL1


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    sec, n = run.trace.kernel_seconds(KERNEL1)
    if sec <= 0:
        return None
    c, w = run.config, run.work
    heads = c["num_attention_heads"]
    d = c["hidden_size"] // heads
    prog = c["program"]
    size = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
            "float8_e4m3": 1}
    kv_item = size[prog.get("kv_dtype", "float32")]
    act_item = size[prog.get("compute_dtype", "float32")]
    table = prog["serve_max_seqs"] * -(-c["max_position_embeddings"]
                                       // prog["kv_page_size"])
    bound = 0.0
    for s in run.traced_steps():
        nbytes, flops = w.paged_step_work(
            s.lanes, s.live_pages, s.lens_sum, run.mixed_width, heads, d,
            act_item, kv_item, prog["kv_page_size"], table)
        bound += c["num_hidden_layers"] * w.roofline_seconds(
            nbytes, flops, run.peaks)
    return 100.0 * bound / sec
