"""The program's own spans in a traced window: every host event named
``repro_torch.*`` (``src/repro_torch/spans.py``), clipped to the window and
reduced per name to

- ``seconds``: the union of its intervals;
- ``count``: how many of them meet the window;
- ``idle_seconds``: the part of that union with nothing running on the card
  (the union less the card's busy intervals).
"""
from __future__ import annotations

import bisect

from portbench.lib.trace import _merge

PREFIX = "repro_torch."


def _overlap(s: int, e: int, busy: list, starts: list) -> int:
    """Nanoseconds of ``[s, e)`` that the sorted, disjoint ``busy`` covers."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    t = 0
    while i < len(busy) and busy[i][0] < e:
        t += max(0, min(e, busy[i][1]) - max(s, busy[i][0]))
        i += 1
    return t


def reduce(events: list, w0: int, w1: int, busy: list) -> dict:
    """``{name: {"seconds", "count", "idle_seconds"}}`` of the host spans
    named ``repro_torch.*`` among ``events`` ((device, kind, name, start_ns,
    end_ns) tuples), in the window ``[w0, w1)``; ``busy`` is the merged,
    sorted list of the card's busy intervals."""
    by_name = {}
    for dev, _, name, s, e in events:
        if dev or not name.startswith(PREFIX):
            continue
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_name.setdefault(name, []).append((s, e))
    starts = [b[0] for b in busy]
    out = {}
    for name, ivs in by_name.items():
        union = _merge(ivs)
        total = sum(e - s for s, e in union)
        covered = sum(_overlap(s, e, busy, starts) for s, e in union)
        out[name] = {"seconds": total / 1e9, "count": len(ivs),
                     "idle_seconds": (total - covered) / 1e9}
    return out
