"""The 1 x 1 compressed convs' share of their roofline (each block's first
and last conv and the projections; a last conv's bytes include its
shortcut's codes): their least time in one request, max(ops at the int8
peak, bytes at 3.35 TB/s), times the traced window's requests, over the
device time of the kernels whose names match PATTERNS (csrc/vdbb_conv_tc.cu
at kh = kw = 1: os_mma.cuh with PointMux, plain and with ResidualFlush)."""
from portbench.lib import peaks
from portbench.lib.cnn_work import conv_work
from portbench.lib.trace import device_seconds

PATTERNS = (("os_mma", "PointMux"),)
KIND = "conv1x1"


def read(ctx):
    secs, launches = device_seconds(ctx.trace, *PATTERNS)
    if not launches:
        return None
    least = sum(peaks.least_seconds(w["ops"], w["bytes"], "int8")
                for w in conv_work(ctx.config, ctx.traffic["batch"]) if w["kind"] == KIND)
    return 100.0 * least * ctx.rec["requests"] / secs
