"""The int8 VDBB matmul kernel's share of its roofline at prefill: the least
time of every compressed projection of one request (the prompt's rows),
max(ops at the int8 peak, bytes at 3.35 TB/s), times the traced window's
requests, over the device time of the kernels whose names match PATTERNS
(the int8 tensor-core core with the gather mux: csrc/vdbb_matmul_tc.cu's
int8 branch)."""
from portbench.lib import peaks
from portbench.lib.trace import device_seconds
from portbench.lib.work import lm_projection_work

PATTERNS = (("os_mma", "GatherMux"),)


def read(ctx):
    secs, launches = device_seconds(ctx.trace, *PATTERNS)
    if not launches:
        return None
    least = sum(peaks.least_seconds(w["ops"], w["bytes"], "int8")
                for w in lm_projection_work(ctx.config, ctx.traffic["seq"], "int8"))
    return 100.0 * least * ctx.rec["requests"] / secs
