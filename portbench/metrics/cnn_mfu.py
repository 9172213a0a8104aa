"""A CNN request's share of the card's peak: the operations one request of
``batch`` images needs (every compressed conv and the head, nnz/bz of the
dense MACs x 2, at the int8 peak; the dense float32 stem at the CUDA cores'
float32 rate, ``cnn_work.FP32_OPS_PER_S``), over the traced window's time
per request."""
from portbench.lib import peaks
from portbench.lib.cnn_work import FP32_OPS_PER_S, int8_ops, stem_ops


def read(ctx):
    c, b = ctx.config, ctx.traffic["batch"]
    least = int8_ops(c, b) / peaks.INT8_OPS_PER_S + stem_ops(c, b) / FP32_OPS_PER_S
    return 100.0 * least / (ctx.rec["window_s"] / ctx.rec["requests"])
