"""The float32 stem's share of its roofline: the least time of one
request's 7 x 7 stem, max(ops at the CUDA cores' float32 rate,
``cnn_work.FP32_OPS_PER_S``, bytes at 3.35 TB/s), times the traced window's
requests, over the device time of the kernels whose names match PATTERNS
(csrc/im2col_conv.cu's direct path, ``direct_conv``). The max-pool is a
kernel of its own (``maxpool_roofline``)."""
from portbench.lib import peaks
from portbench.lib.cnn_work import FP32_OPS_PER_S, conv_work
from portbench.lib.trace import device_seconds

PATTERNS = (("direct_conv",),)


def read(ctx):
    secs, launches = device_seconds(ctx.trace, *PATTERNS)
    if not launches:
        return None
    least = sum(max(w["ops"] / FP32_OPS_PER_S, w["bytes"] / peaks.HBM_BYTES_PER_S)
                for w in conv_work(ctx.config, ctx.traffic["batch"]) if w["kind"] == "stem")
    return 100.0 * least * ctx.rec["requests"] / secs
