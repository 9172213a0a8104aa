"""The share of a generate call's wall time (the harness's host clock) that
is neither its prefill nor its decode steps as generate times them itself
(CUDA events: prefill_ms, and ms_per_step times the gen_len - 1 steps):
re-capture, eager warm-ups and the extra timed prefills. The mean over the
traced window's calls."""


def read(ctx):
    g = ctx.traffic["gen_len"]
    shares = [1.0 - (c["prefill_ms"] + (g - 1) * c["ms_per_step"]) / (1e3 * c["wall_s"])
              for c in ctx.rec["calls"]]
    return 100.0 * sum(shares) / len(shares)
