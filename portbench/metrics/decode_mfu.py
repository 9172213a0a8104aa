"""A decode step's share of the card's bf16 peak: the operations one step
needs at the cell's batch (every compressed projection's nnz/bz of the dense
MACs x 2, attention over the positions each query attends, the dense head),
at the bf16 peak, over generate's own ms per decode step (CUDA events),
the mean over the traced window's calls."""
from portbench.lib import peaks
from portbench.lib.work import (decode_mean_keys, lm_attention_ops, lm_head_ops,
                                 lm_projection_work)


def read(ctx):
    c, t = ctx.config, ctx.traffic
    b = t["batch"]
    ops = (sum(w["ops"] for w in lm_projection_work(c, b, "bf16"))
           + lm_attention_ops(c, b, 1, decode_mean_keys(t)) + lm_head_ops(c, b))
    ms = sum(x["ms_per_step"] for x in ctx.rec["calls"]) / len(ctx.rec["calls"])
    return 100.0 * ops / peaks.BF16_OPS_PER_S / (ms / 1e3)
