"""The 3 x 3 compressed convs' share of their roofline: the least time of
every 3 x 3 conv of one request, max(ops at the int8 peak, bytes at 3.35
TB/s), times the traced window's requests, over the device time of the
kernels whose names match PATTERNS (the tc conv's int8 core over its taps:
csrc/vdbb_conv_tc.cu on os_mma.cuh with TapMux; the 1 x 1 convs launch it
as PointMux)."""
from portbench.lib import peaks
from portbench.lib.cnn_work import conv_work
from portbench.lib.trace import device_seconds

PATTERNS = (("os_mma", "TapMux"),)
KIND = "conv3x3"


def read(ctx):
    secs, launches = device_seconds(ctx.trace, *PATTERNS)
    if not launches:
        return None
    least = sum(peaks.least_seconds(w["ops"], w["bytes"], "int8")
                for w in conv_work(ctx.config, ctx.traffic["batch"]) if w["kind"] == KIND)
    return 100.0 * least * ctx.rec["requests"] / secs
