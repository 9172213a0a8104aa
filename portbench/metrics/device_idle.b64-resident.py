"""The share of the traced window with no operation running on the card
(torch.profiler), in the cell that lists it."""
from portbench.lib.metric import idle_share as read  # noqa: F401
