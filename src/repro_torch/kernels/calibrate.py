"""Per-backend calibration of the autotuner's roofline model (port of
``repro/kernels/calibrate.py``).

The autotuner prunes its candidates with ``max(macs / peak, bytes / bw) +
steps · overhead`` (``autotune.modeled_matmul_cost``). This module measures
the three constants on the machine the search runs on:

1. **probe**: launch the bf16 tc matmul (the kernel with the most launch
   choices) at shapes and choices that spread executed MACs, bytes and the
   steps along a CTA's critical path (waves of CTAs over the 132 SMs, split
   included) over an order of magnitude each, timed with the shared harness
   (the min over ``reps`` samples, ``timing.time_samples_us``);
2. **fit**: least squares of ``t ≈ macs/peak + bytes/bw + steps·overhead``,
   then one active-set pass (:func:`fit_calibration`, pure, the reference's
   math exactly); a zeroed or unidentifiable term keeps its default;
3. **persist** in the autotune cache file under ``calibration[backend]``,
   with its own ``CALIBRATION_VERSION``;
4. **consult**: the modeled costs resolve active → cached → default.

The backend is the device's type, ``'cuda'`` or ``'cpu'``. On a CPU device
nothing is measured: the plain versions take no launch choices, so
:func:`calibrate` returns the defaults there. The defaults are an H100 SXM's
(bf16 dense peak, HBM rate) and a first guess at the overhead of one step.

    python -m repro_torch.kernels.calibrate      # fit on the card and persist
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.vdbb import DBBFormat

CALIBRATION_VERSION = 1

# An H100 SXM's published dense bf16 rate (989 TFLOP/s, in MACs) and HBM
# rate; the overhead of one step (a stage of a CTA on its critical path) is
# a first guess that the fit replaces. Only the candidates' ranking uses them.
DEFAULT_PEAK_MACS = 989e12 / 2
DEFAULT_HBM_BW = 3.35e12
DEFAULT_STEP_OVERHEAD_S = 2e-7


def backend_of(device=None) -> str:
    """The calibration's and the cache's backend: the device's type, by
    default the card's when there is one."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Fitted (or default) roofline constants for one backend."""

    backend: str
    peak_macs: float        # effective MAC/s
    hbm_bw: float           # effective bytes/s
    step_overhead_s: float  # seconds per step on a CTA's critical path
    residual: float = 0.0   # rms relative fit error over the probes
    source: str = "default"  # 'default' | 'fit' | 'cache'


def default_calibration(backend: Optional[str] = None) -> Calibration:
    return Calibration(backend=backend or backend_of(), peak_macs=DEFAULT_PEAK_MACS,
                       hbm_bw=DEFAULT_HBM_BW, step_overhead_s=DEFAULT_STEP_OVERHEAD_S)


# ---------------------------------------------------------------------------
# Cache entry (inside the autotune cache file, with its own version)
# ---------------------------------------------------------------------------


def to_entry(cal: Calibration) -> dict:
    return {"version": CALIBRATION_VERSION, "backend": cal.backend, "peak_macs": cal.peak_macs,
            "hbm_bw": cal.hbm_bw, "step_overhead_s": cal.step_overhead_s,
            "residual": cal.residual}


def from_entry(entry: dict) -> Optional[Calibration]:
    """A cached entry parsed; None on a version mismatch or any non-finite or
    non-positive constant (measurements, not correctness data: dropping one
    is always safe)."""
    if not isinstance(entry, dict) or entry.get("version") != CALIBRATION_VERSION:
        return None
    try:
        vals = [float(entry[k]) for k in ("peak_macs", "hbm_bw", "step_overhead_s")]
    except (KeyError, TypeError, ValueError):
        return None
    if not all(math.isfinite(v) and v > 0 for v in vals):
        return None
    return Calibration(backend=str(entry.get("backend", "")), peak_macs=vals[0],
                       hbm_bw=vals[1], step_overhead_s=vals[2],
                       residual=float(entry.get("residual", 0.0)), source="cache")


# In-process calibrations, one per backend (what the cost model reads first;
# :func:`calibrate` and :func:`set_active` write it).
_ACTIVE: dict = {}


def set_active(cal: Calibration) -> None:
    _ACTIVE[cal.backend] = cal


def clear_active() -> None:
    _ACTIVE.clear()


def get_calibration(backend: Optional[str] = None, cache=None) -> Calibration:
    """Active → cached → default, never None. ``cache`` is an
    ``autotune.TuneCache`` or a path for one."""
    backend = backend or backend_of()
    hit = _ACTIVE.get(backend)
    if hit is not None:
        return hit
    if cache is not None:
        from repro_torch.kernels.autotune import as_cache

        cal = from_entry(as_cache(cache).calibration.get(backend))
        if cal is not None:
            return cal
    return default_calibration(backend)


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------

_PROBE_FMT = DBBFormat(8, 3, "matrix")

# (m, k, n, choice) of the bf16 tc matmul: decode rows bound by bytes with
# 1 to 3 waves of CTAs and 12 to 62 steps each, prefill rows bound by
# operations over 2 to 5 waves, and two small launches bound by their steps.
PROBES = (
    (4, 4608, 4608, {"tile": "small", "split": 1}),
    (4, 4608, 4608, {"tile": "small", "split": 4}),
    (4, 4608, 4608, {"tile": "small", "split": 16}),
    (4, 4608, 18432, {"tile": "small", "split": 1}),
    (1024, 4608, 4608, {"tile": "large", "split": 1}),
    (1024, 4608, 4608, {"tile": "large", "split": 2}),
    (1024, 4608, 18432, {"tile": "large", "split": 1}),
    (128, 1152, 1152, {"tile": "large", "split": 1}),
    (16, 512, 512, {"tile": "small", "split": 1}),
)


def measure_probes(*, reps: int = 9, warmup: int = 1, device=None) -> list:
    """The probes on the card: ``[{macs, bytes, steps, t_s}, ...]``, ``t_s``
    the min of ``reps`` samples."""
    from repro_torch import resolve_device
    from repro_torch.core.vdbb import dbb_encode
    from repro_torch.kernels.autotune import matmul_cost_terms
    from repro_torch.kernels.timing import time_samples_us
    from repro_torch.kernels.vdbb_matmul import vdbb_matmul_tc

    dev = resolve_device(device)
    out = []
    for m, k, n, tiles in PROBES:
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        dw = dbb_encode(torch.randn(k, n, generator=gen, device=dev) * k ** -0.5, _PROBE_FMT,
                        prune=True)
        vals, idx = dw.values.bfloat16().contiguous(), dw.indices[:, :, 0].contiguous()

        def fn(a=a, vals=vals, idx=idx, t=tiles):
            return vdbb_matmul_tc(a, vals, idx, _PROBE_FMT, choice=t)

        t_us = min(time_samples_us(fn, warmup=warmup, reps=reps, device=dev))
        macs, bytes_, steps = matmul_cost_terms(m, k, n, _PROBE_FMT, tiles, 2.0)
        out.append({"macs": macs, "bytes": bytes_, "steps": steps, "t_s": t_us * 1e-6})
    return out


def fit_calibration(probes, backend: Optional[str] = None) -> Calibration:
    """Fit ``t ≈ macs/peak + bytes/bw + steps·overhead`` to measured probes
    (pure: testable with synthetic probes). Least squares, then negative
    coefficients are zeroed and the other columns refit (one active-set
    pass); a zeroed or unidentifiable term keeps its default, so every
    constant returned is finite and positive."""
    import numpy as np

    backend = backend or backend_of()
    X = np.array([[p["macs"], p["bytes"], p["steps"]] for p in probes], float)
    t = np.array([p["t_s"] for p in probes], float)
    if len(probes) < 3 or not np.all(np.isfinite(X)) or not np.all(np.isfinite(t)):
        return default_calibration(backend)
    active = [0, 1, 2]
    coef = np.zeros(3)
    for _ in range(3):  # at most 3 columns can drop
        c, *_ = np.linalg.lstsq(X[:, active], t, rcond=None)
        if np.all(c >= 0):
            coef[:] = 0.0
            coef[active] = c
            break
        active = [a for a, ci in zip(active, c) if ci >= 0]
        if not active:
            return default_calibration(backend)
    pred = X @ coef
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = (pred - t) / np.where(t > 0, t, 1.0)
    residual = float(np.sqrt(np.mean(rel**2)))
    d = default_calibration(backend)
    return Calibration(
        backend=backend,
        peak_macs=1.0 / coef[0] if coef[0] > 0 else d.peak_macs,
        hbm_bw=1.0 / coef[1] if coef[1] > 0 else d.hbm_bw,
        step_overhead_s=coef[2] if coef[2] > 0 else d.step_overhead_s,
        residual=residual,
        source="fit",
    )


def calibrate(cache=None, *, reps: int = 9, warmup: int = 1, force: bool = False,
              save: bool = True, device=None) -> Calibration:
    """Resolve (or measure) the calibration of ``device``'s backend and
    install it. A cache hit skips the probes (``force=True`` measures
    again). On a CPU device nothing is measured: the defaults come back."""
    from repro_torch.kernels.autotune import as_cache

    backend = backend_of(device)
    if backend != "cuda":
        return default_calibration(backend)
    cache = as_cache(cache)
    if not force:
        hit = from_entry(cache.calibration.get(backend))
        if hit is not None:
            set_active(hit)
            return hit
    cal = fit_calibration(measure_probes(reps=reps, warmup=warmup, device=device), backend)
    set_active(cal)
    cache.calibration[backend] = to_entry(cal)
    if save:
        cache.save()
    return cal


def main() -> None:
    """``python -m repro_torch.kernels.calibrate``: fit on the card, persist
    in the autotune cache (``REPRO_AUTOTUNE_CACHE`` or
    ``~/.cache/repro/autotune.json``) and print the constants."""
    from repro_torch.kernels.autotune import TuneCache

    cache = TuneCache()
    cal = calibrate(cache, force=True)
    print(f"backend={cal.backend} source={cal.source} cache={cache.path}")
    print(f"  peak_macs       {cal.peak_macs:.3e} MAC/s")
    print(f"  hbm_bw          {cal.hbm_bw:.3e} B/s")
    print(f"  step_overhead   {cal.step_overhead_s * 1e6:.4f} us/step")
    print(f"  rms rel residual {cal.residual:.3f}")


if __name__ == "__main__":
    main()
