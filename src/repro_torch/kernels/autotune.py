"""Empirical launch-choice autotuner and its persistent cache (port of
``repro/kernels/autotune.py``).

The paper's design-space method applied to the software's own free
parameters: enumerate the candidates of one launch, prune them with the
roofline model, measure the survivors, keep the winner. The port's
candidates are its kernels' launch choices (``kernels/core.py:
launch_choices``), not the reference's Pallas tiles:

- the int8 products (both tc and bw matmuls and convs): tile rows 64 or 128,
  and the tc matmul's wgmma core at prefill rows (``core.WGMMA_CHOICE``);
- the bf16 tc matmul: the small (16 x 128) or large (128 x 256) tile, each
  with every split of K_c from 1 to min(16 or 8, its stages);
- the dense conv: its legal paths (direct, implicit GEMM).

1. **enumerate** the launch's legal choices; the rule's choice
   (``core.default_choice``, what a launch takes with an empty registry) is
   always among them;
2. **prune** with ``max(macs / peak, bytes / bw) + steps · overhead`` over
   :func:`matmul_cost_terms` / :func:`conv_cost_terms` (the accounting of
   ``core.vdbb.dbb_gemm_costs``: A read again for each N tile, the weight for
   each M tile, steps the stages on a CTA's critical path over its waves of
   CTAs on 132 SMs, split included) under the calibrated constants
   (``kernels/calibrate.py``), keeping ``top_k``;
3. **hold** each survivor once against the kernel's plain version on the
   same inputs (int8 exactly, bf16 within ``ref.check_bf16``, fp32 within
   1e-5): a wrong choice raises;
4. **measure** the survivors and the default with the shared harness
   (``timing.median_time_us``: CUDA events around one call after a
   synchronize); a winner other than the default must repeat its win by
   :data:`CONFIRM_MARGIN` in an interleaved head-to-head, else it is
   demoted: the measured tuned time is never above the default's;
5. **persist** in a versioned JSON cache keyed ``backend|kind|sig`` and
   **install** in the ``kernels.core`` registry the plans consult.

The cache file is the reference's format (``version``, ``entries``,
``calibration``) at the reference's default path, so one file can hold the
reference's ``cpu|…`` entries and the port's ``cuda|…`` ones: a save here
keeps every entry it did not write, and a ``cuda`` entry the kernel cannot
run is dropped at load.

**On a CPU device nothing is measured.** The plain versions have no launch
choices, so ``'cache'`` and ``'search'`` resolve to the rule's choices there
and install nothing. The reference instead searches its interpret-mode
Pallas tiles on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
from typing import Optional

import torch

from repro_torch.core.vdbb import DBBFormat, dbb_gemm_costs
from repro_torch.kernels import calibrate, core
from repro_torch.kernels.timing import interleaved_time_us, median_time_us

CACHE_VERSION = 1
MODES = ("off", "cache", "search")

# Searches run in this process (a 'cache' rebuild runs none).
_SEARCHES = [0]


def searches() -> int:
    return _SEARCHES[0]


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------


def default_cache_path() -> pathlib.Path:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro" / "autotune.json"


def cache_key(kind: str, sig: tuple, backend: Optional[str] = None) -> str:
    """``backend|kind|sig...``: a measured choice never crosses backends,
    kernels or launch shapes."""
    backend = backend or calibrate.backend_of()
    return f"{backend}|{kind}|" + "x".join(str(s) for s in sig)


def parse_key(key: str):
    """``(backend, kind, sig)`` of a :func:`cache_key`, or None."""
    try:
        backend, kind, body = key.split("|")
        *dims, dtype = body.split("x")
        return backend, kind, tuple(int(d) for d in dims) + (dtype,)
    except ValueError:
        return None


def _read(path: pathlib.Path) -> tuple:
    """(entries, calibration) of the file, or two empty dicts when it is
    missing, unreadable or of another version (entries are measurements,
    not correctness data: dropping them is always safe)."""
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return {}, {}
    if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
        return {}, {}
    entries = data.get("entries", {})
    cal = data.get("calibration", {})
    return (dict(entries) if isinstance(entries, dict) else {},
            dict(cal) if isinstance(cal, dict) else {})


def _valid(key: str, entry) -> bool:
    """False for a ``cuda`` entry the kernel cannot run; the reference's
    backends' entries are not the port's to judge."""
    if not key.startswith("cuda|"):
        return True
    parsed = parse_key(key)
    try:
        core.check_choice(parsed[1], parsed[2], entry["tiles"])
    except (KeyError, TypeError, ValueError):
        return False
    return True


class TuneCache:
    """Versioned on-disk JSON cache of measured launch choices, with the
    per-backend calibration (``kernels/calibrate.py``) under its own
    version. A version mismatch or an unreadable file empties it; a ``cuda``
    entry the kernel cannot run is dropped at load."""

    def __init__(self, path=None):
        self.path = pathlib.Path(path) if path is not None else default_cache_path()
        self.entries: dict = {}
        self.calibration: dict = {}
        self.load()

    def load(self) -> None:
        entries, self.calibration = _read(self.path)
        self.dropped = {k for k, e in entries.items() if not _valid(k, e)}
        self.entries = {k: e for k, e in entries.items() if k not in self.dropped}
        self._loaded = (dict(self.entries), dict(self.calibration))

    def get(self, key: str) -> Optional[dict]:
        return self.entries.get(key)

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = entry

    def save(self) -> None:
        """Write through a temporary file and an atomic rename. What this
        cache wrote (put, or changed since its load) goes over the file's
        current content; everything else the file holds is kept, so the
        reference and the port can share one file."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        disk_entries, disk_cal = _read(self.path)
        loaded_entries, loaded_cal = self._loaded
        entries = {**self.entries,
                   **{k: e for k, e in disk_entries.items() if k not in self.dropped},
                   **{k: e for k, e in self.entries.items() if loaded_entries.get(k) != e}}
        cal = {**self.calibration, **disk_cal,
               **{b: e for b, e in self.calibration.items() if loaded_cal.get(b) != e}}
        fd, tmp = tempfile.mkstemp(dir=self.path.parent, prefix=self.path.name + ".")
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps({"version": CACHE_VERSION, "entries": entries,
                                "calibration": cal}, indent=2, sort_keys=True))
        os.replace(tmp, self.path)
        self.entries, self.calibration = entries, cal
        self._loaded = (dict(entries), dict(cal))


def as_cache(cache) -> TuneCache:
    return cache if isinstance(cache, TuneCache) else TuneCache(cache)


def install(kind: str, sig: tuple, tiles: dict) -> None:
    """Install a choice in the ``kernels.core`` registry (validated there)."""
    core.set_tuned(kind, sig, tiles)


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------


def matmul_kind(fmt: DBBFormat, n: int) -> str:
    return core.KIND_MATMUL_TC if fmt.group_size(n) == n else core.KIND_MATMUL_BW


def conv_kind(fmt: Optional[DBBFormat], f: int) -> str:
    if fmt is None:
        return core.KIND_CONV_DENSE
    return core.KIND_CONV_TC if fmt.group_size(f) == f else core.KIND_CONV_BW


def _conv_sig(batch, ho, wo, c, f, kh, kw, sh, sw, fmt, dtype) -> tuple:
    bz, nnz = (0, 0) if fmt is None else (fmt.bz, fmt.nnz)
    return core.conv_sig(batch, ho, wo, c, f, kh, kw, sh, sw, bz, nnz, dtype)


def matmul_candidates(m: int, k: int, n: int, fmt: DBBFormat, dtype) -> list:
    """Every launch choice of one compressed-matmul launch."""
    return core.launch_choices(matmul_kind(fmt, n), core.matmul_sig(m, k, n, fmt.bz, fmt.nnz,
                                                                    dtype))


def conv_candidates(batch, ho, wo, c, f, kh, kw, sh, sw, fmt, dtype) -> list:
    """Every launch choice of one conv launch (``fmt=None``: the dense conv)."""
    return core.launch_choices(conv_kind(fmt, f),
                               _conv_sig(batch, ho, wo, c, f, kh, kw, sh, sw, fmt, dtype))


def default_matmul_tiles(m: int, k: int, n: int, fmt: DBBFormat, dtype):
    """The rule's choice (what an untuned launch takes): the baseline every
    search measures."""
    return core.default_choice(matmul_kind(fmt, n),
                               core.matmul_sig(m, k, n, fmt.bz, fmt.nnz, dtype))


def default_conv_tiles(batch, ho, wo, c, f, kh, kw, sh, sw, fmt, dtype):
    return core.default_choice(conv_kind(fmt, f),
                               _conv_sig(batch, ho, wo, c, f, kh, kw, sh, sw, fmt, dtype))


# ---------------------------------------------------------------------------
# Pruning model (roofline over the cost accounting)
# ---------------------------------------------------------------------------


def _launch_shape(tiles: dict, nnz: int) -> tuple:
    """(tile rows, tile columns, split, K elements a stage, ring, CTAs an
    SM) of a product's launch choice (``nnz`` the format's: a stage of the
    wgmma core holds 32 blocks of K)."""
    if tiles.get("core") == "wgmma":
        return (core.WGMMA_TILE_ROWS, core.WGMMA_TILE_COLS, 1, core.WGMMA_BLOCKS * nnz,
                core.wgmma_stages(nnz), 1)
    if "tile_rows" in tiles:
        return (tiles["tile_rows"], core.MMA_TILE_COLS, 1, core.MMA_BK, core.MMA_STAGES,
                core.MMA_BLOCKS_PER_SM)
    t = tiles["tile"]
    rows, cols, _ = core.BF16_TILES[t]
    return (rows, cols, tiles["split"], core.BF16_BK, core.BF16_STAGES[t],
            core.BF16_BLOCKS_PER_SM[t])


def _product_terms(m: int, kloop: int, n: int, macs: float, act_bytes: float,
                   weight_bytes: float, tiles: dict, nnz: int = 3) -> tuple:
    """(executed MACs, bytes, steps) of an output-stationary product under a
    launch choice: padded rows and columns charged their wasted MACs, A read
    once per N tile, the weight once per M tile, and the steps (stages a CTA
    runs, its ring's fill and flush included) over its waves of CTAs."""
    bm, bn, split, depth, ring, per_sm = _launch_shape(tiles, nnz)
    mp, n_pad = -(-m // bm) * bm, -(-n // bn) * bn
    ctas = (mp // bm) * (n_pad // bn) * split
    waves = -(-ctas // (core.BF16_SMS * per_sm))
    stages = -(-kloop // depth)
    steps = waves * (-(-stages // split) + ring)
    act = act_bytes * (n_pad // bn) * (mp / m)
    wt = weight_bytes * (mp // bm)
    return macs * (mp * n_pad) / (m * n), act + wt + m * n * 4, steps


def matmul_cost_terms(m: int, k: int, n: int, fmt: DBBFormat, tiles: dict,
                      itemsize: float = 4.0) -> tuple:
    """``(executed_macs, hbm_bytes, steps)`` of one compressed-matmul launch
    under a launch choice: the three roofline terms, shared by the modeled
    cost and the calibration fit. The tc kernel runs over the compressed K,
    the bw kernel over the dense K."""
    c = dbb_gemm_costs(m, k, n, fmt, bits=int(8 * itemsize), act_bits=int(8 * itemsize))
    tc = fmt.group_size(n) == n
    kloop = k // fmt.bz * fmt.nnz if tc else k
    macs = c["executed_macs"] if tc else c["dense_macs"]
    return _product_terms(m, kloop, n, macs, c["act_bytes"], c["weight_bytes"], tiles, fmt.nnz)


def conv_cost_terms(batch: int, ho: int, wo: int, c_in: int, f: int, kh: int, kw: int,
                    sh: int, sw: int, fmt: Optional[DBBFormat], tiles: dict,
                    itemsize: float = 4.0) -> tuple:
    """Conv twin of :func:`matmul_cost_terms`: the GEMM of M = batch·ho·wo,
    K = kh·kw·c_in, N = f with the raw input (about batch·ho·sh·wo·sw·c_in
    elements) as A's stream. The dense conv's paths share one cost (steps 0):
    the measurement tells them apart."""
    m, k = batch * ho * wo, kh * kw * c_in
    g = dbb_gemm_costs(m, k, f, fmt or DBBFormat(), bits=int(8 * itemsize),
                       act_bits=int(8 * itemsize))
    raw = batch * ho * sh * wo * sw * c_in * itemsize
    if "path" in tiles:
        return g["dense_macs"], raw + k * f * itemsize + m * f * 4, 0
    tc = fmt.group_size(f) == f
    kloop = k // fmt.bz * fmt.nnz if tc else k
    macs = g["executed_macs"] if tc else g["dense_macs"]
    return _product_terms(m, kloop, f, macs, raw, g["weight_bytes"], tiles)


def _modeled(terms: tuple, cal) -> float:
    macs, bytes_, steps = terms
    return max(macs / cal.peak_macs, bytes_ / cal.hbm_bw) + steps * cal.step_overhead_s


def modeled_matmul_cost(m: int, k: int, n: int, fmt: DBBFormat, tiles: dict,
                        itemsize: float = 4.0, cal=None) -> float:
    """Modeled seconds of one matmul launch under a launch choice, with the
    active, cached or default calibration."""
    cal = cal or calibrate.get_calibration()
    return _modeled(matmul_cost_terms(m, k, n, fmt, tiles, itemsize), cal)


def modeled_conv_cost(batch: int, ho: int, wo: int, c_in: int, f: int, kh: int, kw: int,
                      sh: int, sw: int, fmt: Optional[DBBFormat], tiles: dict,
                      itemsize: float = 4.0, cal=None) -> float:
    """Modeled seconds of one conv launch under a launch choice."""
    cal = cal or calibrate.get_calibration()
    return _modeled(conv_cost_terms(batch, ho, wo, c_in, f, kh, kw, sh, sw, fmt, tiles,
                                    itemsize), cal)


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one tuning query (searched, or replayed from the cache)."""

    kind: str
    sig: tuple
    tiles: dict            # the measured best choice
    measured_us: float     # its time
    default_tiles: dict    # the rule's choice
    default_us: float      # its time, same harness and run
    modeled_best_us: float
    modeled_default_us: float
    n_candidates: int
    source: str            # 'search' | 'cache'

    @property
    def speedup(self) -> float:
        return self.default_us / max(self.measured_us, 1e-9)


# A winner must beat the default by this factor in the interleaved
# confirmation, or it is demoted to the default: a tie or a loss is never
# persisted.
CONFIRM_MARGIN = 1.05


def interleaved_medians(fn_a, fn_b, *, warmup: int = 1, reps: int = 5, stat: str = "median",
                        device=None):
    """Times (µs) of two nullary callables sampled alternately (A, B, A, B,
    …): :func:`timing.interleaved_time_us`."""
    return interleaved_time_us(fn_a, fn_b, warmup=warmup, reps=reps, stat=stat, device=device)


def _search(kind, sig, candidates, cost_fn, build, default_tiles, *, top_k, reps, warmup,
            cache, save, check=None, device=None):
    cands = [dict(t) for t in candidates]
    if default_tiles not in cands:
        cands.append(dict(default_tiles))
    ranked = sorted(cands, key=cost_fn)
    survivors = ranked[: max(1, top_k)]
    if default_tiles not in survivors:
        survivors.append(default_tiles)  # the baseline is always measured
    _SEARCHES[0] += 1
    timed = []
    for t in survivors:
        if check is not None:
            check(t)  # a wrong choice raises before it is timed
        timed.append((median_time_us(build(t), warmup=warmup, reps=reps, device=device), t))
    best_us, best = min(timed, key=lambda p: p[0])
    default_us = next(us for us, t in timed if t == default_tiles)
    if best != default_tiles:
        b_us, d_us = interleaved_medians(build(best), build(default_tiles), warmup=1,
                                         reps=max(reps, 3), device=device)
        if b_us * CONFIRM_MARGIN <= d_us:
            best_us, default_us = b_us, d_us
        else:
            best, best_us, default_us = dict(default_tiles), d_us, d_us
    res = TuneResult(
        kind=kind, sig=sig, tiles=best, measured_us=best_us,
        default_tiles=default_tiles, default_us=default_us,
        modeled_best_us=cost_fn(ranked[0]) * 1e6,
        modeled_default_us=cost_fn(default_tiles) * 1e6,
        n_candidates=len(cands), source="search",
    )
    install(kind, sig, best)
    if cache is not None:
        cache.put(cache_key(kind, sig, "cuda"), _entry(res))
        if save:
            cache.save()
    return res


def _entry(res: TuneResult) -> dict:
    return {"tiles": res.tiles, "measured_us": res.measured_us,
            "default_tiles": res.default_tiles, "default_us": res.default_us,
            "modeled_best_us": res.modeled_best_us,
            "modeled_default_us": res.modeled_default_us, "n_candidates": res.n_candidates}


def _from_entry(kind, sig, e: dict) -> TuneResult:
    return TuneResult(kind=kind, sig=sig, tiles=dict(e["tiles"]), measured_us=e["measured_us"],
                      default_tiles=dict(e["default_tiles"]), default_us=e["default_us"],
                      modeled_best_us=e["modeled_best_us"],
                      modeled_default_us=e["modeled_default_us"],
                      n_candidates=e["n_candidates"], source="cache")


def _card(device) -> torch.device:
    from repro_torch import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("nothing is tuned on the CPU: the plain versions take no launch choices")
    return dev


def _cached(kind, sig, cache: TuneCache):
    hit = cache.get(cache_key(kind, sig, "cuda"))
    if hit is None:
        return None
    install(kind, sig, hit["tiles"])
    return _from_entry(kind, sig, hit)


def _checker(run, plain, dtype, order=None):
    """The check of a choice against the plain version on the same inputs:
    int8 exactly, bf16 within one ulp plus the reordering bound
    (``ref.check_bf16``), fp32 within rtol = atol = 1e-5."""
    from repro_torch.kernels.ref import check_bf16

    want = plain()

    def check(t):
        got = run(t)
        what = f"autotune: launch choice {t}"
        if dtype == torch.bfloat16:
            check_bf16(got, want, order(), what)
        elif dtype == torch.int8:
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"{what} differs from the plain version")
        elif not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{what}: max |diff| {float((got - want).abs().max())}")

    return check


def _operands(gen, dev, shape, dtype):
    x = torch.randn(*shape, generator=gen, device=dev)
    if dtype == torch.int8:
        from repro_torch.core.quant import dynamic_act_scale, quantize

        return quantize(x, dynamic_act_scale(x))
    return x.to(dtype)


def tune_matmul(m: int, k: int, n: int, fmt: DBBFormat, *, dtype=torch.float32, top_k: int = 4,
                reps: int = 3, warmup: int = 1, cache=None, save: bool = True,
                force: bool = False, seed: int = 0, device=None) -> TuneResult:
    """The measured best launch choice of one compressed-matmul launch on
    the card. A cache hit skips the search (``force=True`` measures again);
    the winner is installed in the registry either way. Inputs come from a
    seeded ``torch.Generator`` on the device."""
    from repro_torch.core.quant import quantize_dbb
    from repro_torch.core.vdbb import dbb_encode
    from repro_torch.kernels import vdbb_matmul as vm
    from repro_torch.kernels.ref import bf16_reorder_bound

    dev = _card(device)
    kind = matmul_kind(fmt, n)
    sig = core.matmul_sig(m, k, n, fmt.bz, fmt.nnz, dtype)
    cands = matmul_candidates(m, k, n, fmt, dtype)
    if not cands:
        raise ValueError(f"{kind} at {sig}: the launch takes no choice")
    cache = as_cache(cache)
    if not force:
        hit = _cached(kind, sig, cache)
        if hit is not None:
            return hit
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = _operands(gen, dev, (m, k), dtype)
    dw = dbb_encode(torch.randn(k, n, generator=gen, device=dev) * k ** -0.5, fmt, prune=True)
    values = quantize_dbb(dw).values if dtype == torch.int8 else dw.values.to(dtype)
    tc = kind == core.KIND_MATMUL_TC
    idx = dw.indices[:, :, 0].contiguous() if tc else dw.indices
    kernel, plain = (vm.vdbb_matmul_tc, vm.vdbb_matmul_tc_plain) if tc else (
        vm.vdbb_matmul_bw, vm.vdbb_matmul_bw_plain)

    def build(t):
        return lambda: kernel(a, values, idx, fmt, choice=t)

    check = _checker(lambda t: build(t)(), lambda: plain(a, values, idx, fmt), dtype,
                     lambda: bf16_reorder_bound(a, values, idx, fmt.bz))
    itemsize = float(torch.empty((), dtype=dtype).element_size())
    cal = calibrate.get_calibration("cuda", cache=cache)
    return _search(kind, sig, cands,
                   lambda t: modeled_matmul_cost(m, k, n, fmt, t, itemsize, cal=cal),
                   build, default_matmul_tiles(m, k, n, fmt, dtype), top_k=top_k, reps=reps,
                   warmup=warmup, cache=cache, save=save, check=check, device=dev)


def tune_conv(batch: int, h: int, w: int, c: int, f: int, kh: int, kw: int,
              fmt: Optional[DBBFormat] = None, *, stride=1, padding="SAME",
              dtype=torch.float32, top_k: int = 4, reps: int = 3, warmup: int = 1, cache=None,
              save: bool = True, force: bool = False, seed: int = 0,
              device=None) -> TuneResult:
    """The measured best launch choice of one conv launch on the card:
    ``fmt=None`` the dense conv (its path), a format the IM2COL × VDBB conv
    in its tc or bw mode (its tile rows)."""
    from repro_torch.core.quant import quantize_dbb
    from repro_torch.core.vdbb import dbb_encode_conv
    from repro_torch.kernels import im2col_conv as dense
    from repro_torch.kernels import vdbb_im2col_conv as vc

    dev = _card(device)
    (sh, sw), _, (ho, wo) = core.conv_geometry(h, w, kh, kw, stride, padding)
    kind = conv_kind(fmt, f)
    sig = _conv_sig(batch, ho, wo, c, f, kh, kw, sh, sw, fmt, dtype)
    cands = conv_candidates(batch, ho, wo, c, f, kh, kw, sh, sw, fmt, dtype)
    if not cands:
        raise ValueError(f"{kind} at {sig}: the launch takes no choice")
    cache = as_cache(cache)
    if not force:
        hit = _cached(kind, sig, cache)
        if hit is not None:
            return hit
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _operands(gen, dev, (batch, h, w, c), dtype)
    w4 = torch.randn(kh, kw, c, f, generator=gen, device=dev) * (kh * kw * c) ** -0.5
    geom = dict(stride=stride, padding=padding)
    if fmt is None:
        wd = _operands(gen, dev, (kh, kw, c, f), dtype) if dtype == torch.int8 else w4.to(dtype)
        kernel = lambda t: dense.im2col_conv(x, wd, **geom, choice=t)  # noqa: E731
        plain = lambda: dense.im2col_conv_plain(x, wd, **geom)  # noqa: E731
    else:
        dw = dbb_encode_conv(w4, fmt, prune=True)
        values = quantize_dbb(dw).values if dtype == torch.int8 else dw.values.to(dtype)
        tc = kind == core.KIND_CONV_TC
        idx = dw.indices[:, :, 0].contiguous() if tc else dw.indices
        run, ref_ = ((vc.vdbb_im2col_conv_tc, vc.vdbb_im2col_conv_tc_plain) if tc
                     else (vc.vdbb_im2col_conv_bw, vc.vdbb_im2col_conv_bw_plain))
        kernel = lambda t: run(x, values, idx, fmt, kh, kw, **geom, choice=t)  # noqa: E731
        plain = lambda: ref_(x, values, idx, fmt, kh, kw, **geom)  # noqa: E731

    def build(t):
        return lambda: kernel(t)

    itemsize = float(torch.empty((), dtype=dtype).element_size())
    cal = calibrate.get_calibration("cuda", cache=cache)
    return _search(kind, sig, cands,
                   lambda t: modeled_conv_cost(batch, ho, wo, c, f, kh, kw, sh, sw, fmt, t,
                                               itemsize, cal=cal),
                   build, default_conv_tiles(batch, ho, wo, c, f, kh, kw, sh, sw, fmt, dtype),
                   top_k=top_k, reps=reps, warmup=warmup, cache=cache, save=save,
                   check=_checker(kernel, plain, dtype), device=dev)


# ---------------------------------------------------------------------------
# Plan-time resolution (registry → cache → optional search)
# ---------------------------------------------------------------------------


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"tune={mode!r}: expected one of {MODES}")


def _resolve(kind, sig, mode, cache, device, tune) -> dict:
    check_mode(mode)
    if mode == "off" or torch.device(device).type != "cuda":
        return {}  # nothing is measured on the CPU: the rule's choices
    if not core.launch_choices(kind, sig):
        return {}
    t = core.lookup_tiles(kind, sig)
    if t:
        return dict(t)
    cache = as_cache(cache)
    hit = _cached(kind, sig, cache)
    if hit is not None:
        return dict(hit.tiles)
    if mode != "search":
        return {}
    return dict(tune(cache).tiles)


def tiles_for_matmul(m, k, n, fmt, dtype, *, mode: str = "cache", cache=None, top_k: int = 4,
                     reps: int = 3, device=None) -> dict:
    """The launch choice of a matmul launch under a tuning ``mode``:
    ``'off'`` ({}: the rule's), ``'cache'`` (registry or cache hits only,
    never a search), ``'search'`` (search on a miss and persist). {} on a
    CPU ``device`` and for a launch without choices."""
    device = calibrate.backend_of() if device is None else device
    return _resolve(matmul_kind(fmt, n), core.matmul_sig(m, k, n, fmt.bz, fmt.nnz, dtype), mode,
                    cache, device,
                    lambda c: tune_matmul(m, k, n, fmt, dtype=dtype, top_k=top_k, reps=reps,
                                          cache=c, device=device))


def tiles_for_conv(batch, h, w, c, f, kh, kw, fmt, dtype, *, stride=1, padding="SAME",
                   mode: str = "cache", cache=None, top_k: int = 4, reps: int = 3,
                   device=None) -> dict:
    """Conv twin of :func:`tiles_for_matmul` (``fmt=None``: the dense conv)."""
    device = calibrate.backend_of() if device is None else device
    (sh, sw), _, (ho, wo) = core.conv_geometry(h, w, kh, kw, stride, padding)
    return _resolve(conv_kind(fmt, f), _conv_sig(batch, ho, wo, c, f, kh, kw, sh, sw, fmt, dtype),
                    mode, cache, device,
                    lambda cc: tune_conv(batch, h, w, c, f, kh, kw, fmt, stride=stride,
                                         padding=padding, dtype=dtype, top_k=top_k, reps=reps,
                                         cache=cc, device=device))
