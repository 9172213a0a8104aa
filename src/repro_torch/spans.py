"""Named host spans on the profiler's clock.

``span(name)`` marks a phase of the program for ``torch.profiler``: while a
profiler records, it is a record function named ``"repro_torch." + name``
(torch's light ``_RecordFunctionFast``), so the span lands in the Kineto
trace on the same clock as the card's kernels, copies and fills, and an idle
stretch of the card can be put down to the phase the host was in. While
nothing records it is one shared null context, and its whole cost is one
check of the profiler's state (about 0.5 us; a bare
``torch.profiler.record_function`` costs about 15 us even with no profiler),
so spans may sit on a serving path. A span never synchronizes, reads no
tensor and launches nothing.

While a profiler records, a span costs about 1.3 us of host time, where
``torch.profiler.record_function`` costs about 12 us; and being no user
annotation, it gets no device-side copy among the card's events (a
``gpu_user_annotation`` as long as the kernels the span launched, gaps
between them included), which every reading of busy time would have to
leave out. Readers of kernels and busy time leave out such copies all the
same, of whatever annotation wraps them: :func:`is_span`.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around one phase: a record function named
    ``PREFIX + name`` while a profiler records, else the shared null
    context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def is_span(event) -> bool:
    """Whether an event of ``prof.events()`` is a span or an annotation
    (this program's, a harness's, or the card's copy of one) rather than
    work on the card."""
    return bool(getattr(event, "is_user_annotation", False)) or event.name.startswith(PREFIX)
