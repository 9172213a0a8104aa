"""A prefill's share of the card's peak: the operations one request needs
(every compressed projection at the prompt's rows, nnz/bz of the dense MACs
x 2 at the int8 peak; causal attention over the pairs the mask keeps and
the head's one row of next-token logits at the bf16 peak), over the traced
window's time per request."""
from portbench.lib import peaks
from portbench.lib.work import lm_attention_ops, lm_head_ops, lm_projection_work


def read(ctx):
    c, s = ctx.config, ctx.traffic["seq"]
    least = (sum(w["ops"] for w in lm_projection_work(c, s, "int8")) / peaks.INT8_OPS_PER_S
             + (lm_attention_ops(c, 1, s, (s + 1) / 2) + lm_head_ops(c, 1))
             / peaks.BF16_OPS_PER_S)
    return 100.0 * least / (ctx.rec["window_s"] / ctx.rec["requests"])
