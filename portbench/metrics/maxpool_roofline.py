"""The max-pool's share of its roofline: one request's int8 codes in and out
at 3.35 TB/s, times the traced window's requests, over the device time of
the kernels whose names match PATTERNS (csrc/maxpool.cuh)."""
from portbench.lib import peaks
from portbench.lib.cnn_work import maxpool_bytes
from portbench.lib.trace import device_seconds

PATTERNS = (("maxpool::kernel",),)


def read(ctx):
    secs, launches = device_seconds(ctx.trace, *PATTERNS)
    if not launches:
        return None
    least = maxpool_bytes(ctx.config, ctx.traffic["batch"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * least * ctx.rec["requests"] / secs
