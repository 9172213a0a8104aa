"""Readings that several per-layer metrics share."""


def idle_share(ctx):
    """The traced window's share, in %, with no operation on the card."""
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
