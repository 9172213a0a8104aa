"""The bf16 VDBB matmul kernel's share of its roofline at decode: the least
time of every compressed projection of one decode step at the cell's batch,
max(ops at the bf16 peak, bytes at 3.35 TB/s), times the decode steps the
traced calls ran (every decode forward generate counts, less the one each
capture records without running it), over the device time of the kernels
whose names match PATTERNS: the bf16 tensor-core core with the word gather
(csrc/vdbb_matmul_tc.cu's bf16 branch) in its 16 x 128 decode tile, its
name demangled or mangled."""
from portbench.lib import peaks
from portbench.lib.trace import device_seconds
from portbench.lib.work import lm_projection_work

PATTERNS = (("bf16_mma", "WordGather", "kernel<16, 128"),
            ("bf16_mma", "WordGather", "ILi16ELi128E"))


def read(ctx):
    secs, launches = device_seconds(ctx.trace, *PATTERNS)
    if not launches:
        return None
    least = sum(peaks.least_seconds(w["ops"], w["bytes"], "bf16")
                for w in lm_projection_work(ctx.config, ctx.traffic["batch"], "bf16"))
    steps = sum(c["forwards"]["decode"] - (1 if c["captures"] else 0) for c in ctx.rec["calls"])
    return 100.0 * least * steps / secs
