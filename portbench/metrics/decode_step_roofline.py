"""A decode step's share of its roofline: the bytes one step must move
(every compressed projection's values and positions, biases, norms, the
batch's embedding rows, the dense head, the K/V of the positions each query
attends, read, and one position written) at 3.35 TB/s, over generate's own
ms per decode step (CUDA events), the mean over the traced window's calls."""
from portbench.lib import peaks
from portbench.lib.work import decode_mean_keys, lm_decode_step_bytes


def read(ctx):
    t = ctx.traffic
    nbytes = lm_decode_step_bytes(ctx.config, t["batch"], decode_mean_keys(t))
    ms = sum(x["ms_per_step"] for x in ctx.rec["calls"]) / len(ctx.rec["calls"])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / (ms / 1e3)
