"""Frozen serving plans on CUDA graphs (port of ``repro/models/plan.py``).

A :class:`ModelPlan` is the once-per-model resolution of what the unplanned
forward redoes on every call. Each layer's serving step is staged by its
``make_plan`` with the layer's tensors frozen in and the host work done
once: the dequant scale product, the shared pattern's index row, the
flush's epilogue rows, and the int8 tile plans and the stem's path (a
layer's :attr:`LayerPlan.tiles`).

On a card, a plan captures its staged chain once per input signature into a
``torch.cuda.CUDAGraph``, the counterpart of the reference's one
``jax.jit`` trace per signature: :meth:`ModelPlan.serve` copies the input
into the graph's static input, replays the graph and returns a copy of its
static output. A replay runs the kernels, the pooling mean and the head's
input quantize, and no Python. :attr:`ModelPlan.trace_count` counts
captures (on the CPU, where the staged chain runs eagerly on the plain
versions, the signatures staged), so the serving tier's zero-retrace
contract reads the same on both. The kernel wrappers count their launches
at capture, not at replay: :attr:`ModelPlan.graph_launches` keeps each
graph's count and :attr:`ModelPlan.replays` the replays.

A graph reads the frozen tensors by address and the plan keeps a reference
to each, so after an in-place ``quantize()`` or ``compress()`` of the model
the old graph still reads live memory, and :meth:`ModelPlan.check` raises
:class:`StalePlanError` because the fingerprint moved.

A :class:`PlanSet` is a ladder of plans, one per batch-size bucket, whose
graphs share one memory pool (:class:`GraphPool`). ``serve`` pads a ragged
batch up to the nearest bucket and slices the padding off, bit-identical to
serving each request alone (rows are independent through conv, GEMM and
pooling).

Each stage's launch choice (the int8 tile rows, the bf16 tile and split,
the stem's path) is resolved at the build under ``tune`` ('off': the rule's;
'cache': the tuned registry or the autotune cache; 'search': a measured
search on a miss, ``kernels/autotune.py``) and frozen into the stage, so a
later change of the registry reaches no built plan, graphed or eager.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from types import MappingProxyType
from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import act_sparsity
from repro_torch.kernels import build


class StalePlanError(RuntimeError):
    """A frozen plan was used with a state it was not built from."""


def _hash_leaf(h, path: str, v) -> None:
    h.update(path.encode())
    if isinstance(v, dict):
        for k in sorted(v):
            _hash_leaf(h, f"{path}/{k}", v[k])
    elif isinstance(v, torch.Tensor):
        t = v.detach().contiguous().cpu()
        h.update(f"{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        h.update(type(v).__name__.encode())
        for f in dataclasses.fields(v):
            _hash_leaf(h, f"{path}.{f.name}", getattr(v, f.name))
    else:
        h.update(repr(v).encode())


def params_fingerprint(params) -> str:
    """Content hash of a state tree (``SparseCNN.state()``): the sorted key
    paths, each tensor's shape, dtype and bytes, and every field of a
    compressed weight, its ``DBBFormat`` and dense shape included. Any later
    re-quantize, re-compress or re-calibration changes it."""
    h = hashlib.sha1()
    _hash_leaf(h, "", params)
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One staged serving stage: a name, the kind, the resolved tile plan
    (sorted (key, value) pairs; empty for the pooling stage and the
    per-layer path), and the ``x -> y`` closure with its tensors frozen in."""

    name: str
    kind: str  # 'conv' | 'linear' | 'pool'
    tiles: Tuple[Tuple[str, Any], ...]
    run: Callable[[Any], Any]


# One lock for every graph in the process. A capture runs in CUDA's global
# capture mode, in which a call another thread makes meanwhile (a copy from
# pageable memory, a launch on the default stream, a synchronize) fails
# that call or the capture. So a capture, and each serve's input copy,
# replay and output copy, take this lock: a capture on one thread (a hot
# reload's warmup) holds the dispatcher off for as long as it lasts, and
# graphs that share a pool never interleave on the stream. Reentrant: a
# serve captures on a first use while it holds the lock.
GRAPH_LOCK = threading.RLock()


class GraphPool:
    """A CUDA graph memory pool. Graphs sharing a pool may reuse each
    other's intermediates; :data:`GRAPH_LOCK` orders them."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()


def capture(fn: Callable[[], Any], pool: GraphPool, device) -> tuple:
    """``fn()`` captured into a CUDA graph from ``pool``: the counterpart of
    one ``jax.jit`` trace. ``fn`` reads its inputs from static tensors it
    closes over; its outputs, and any tensor it writes in place, are static
    too, so a replay writes them again. ``fn`` first runs once eagerly on a
    side stream (its kernels are built and their libraries loaded before
    the capture, and its side effects happen once), and nothing it does may
    reach the host. Returns ``(graph, outputs, launches)``: ``launches`` is
    what the kernel wrappers counted during the capture, what one replay
    launches (the counters do not see replays). Both runs hold
    :data:`GRAPH_LOCK`; so must any other thread's work on the card that
    could meet a capture. Raises while an activation collector is
    installed: it reads every projection's input on the host."""
    if act_sparsity.collecting():
        raise RuntimeError("no CUDA graph is captured while activation stats are collected: "
                           "the collector reads each projection's input on the host")
    with GRAPH_LOCK:
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn()
        stream.wait_stream(side)
        before = build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool.handle):
            out = fn()
    launches = {k: n - before.get(k, 0) for k, n in build.launch_counts().items()}
    return graph, out, launches


@dataclasses.dataclass
class _Graph:
    graph: Any
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: dict


@dataclasses.dataclass(frozen=True)
class ModelPlan:
    """Immutable per-model serving plan: build with ``SparseCNN.plan()``.

    ``serve(x)`` (also ``plan(x)``) runs the staged chain: on a card by
    replaying the graph captured for ``x``'s (shape, dtype), capturing it
    on first use; on the CPU eagerly. ``graphs=False`` runs it eagerly on a
    card too, each kernel launched by its wrapper (a serving fallback's,
    ``SparseCNN.fallback_plan_set``). ``check(state)`` raises
    :class:`StalePlanError` on a fingerprint mismatch.
    """

    model: str
    fingerprint: str
    layers: Tuple[LayerPlan, ...]
    batch: Optional[int] = None  # the batch the plan was staged for
    # One sample's (shape without the batch, dtype name), e.g.
    # ((64, 64, 3), 'float32'): the serving tier validates every request
    # against it at admission.
    sample_spec: Optional[Tuple[Tuple[int, ...], str]] = None
    device: Optional[torch.device] = None  # where the staged tensors lie: required
    pool: Optional[GraphPool] = None  # shared by a PlanSet's buckets
    graphs: bool = True  # on a card: replay captured graphs (else run eagerly)

    def __post_init__(self):
        if self.device is None:
            raise ValueError(f"plan {self.model!r}: no device; a plan runs where its staged "
                             "tensors lie, so pass the model's device")
        object.__setattr__(self, "device", torch.device(self.device))
        if self.device.type == "cuda" and self.graphs and self.pool is None:
            object.__setattr__(self, "pool", GraphPool())
        object.__setattr__(self, "_graphs", {})  # signature -> _Graph, on a card
        object.__setattr__(self, "_signatures", set())  # staged on the CPU
        object.__setattr__(self, "_replays", [0])

    def _chain(self, x):
        for layer in self.layers:
            x = layer.run(x)
        return x

    def serve(self, x: torch.Tensor) -> torch.Tensor:
        """Steady-state serving: no checks, no state. On a card ``x`` may
        lie on the host or the card and the logits come back on the card."""
        with torch.no_grad():
            if self.device.type != "cuda":
                self._signatures.add((tuple(x.shape), x.dtype))
                return self._chain(x.to(self.device))
            if not self.graphs:
                with GRAPH_LOCK:  # a capture on another thread must not meet its launches
                    self._signatures.add((tuple(x.shape), x.dtype))
                    return self._chain(x.to(self.device))
            with GRAPH_LOCK:
                g = self._graphs.get((tuple(x.shape), x.dtype)) or self._capture(x)
                g.static_in.copy_(x)
                g.graph.replay()
                self._replays[0] += 1
                return g.static_out.clone()

    def _capture(self, x) -> _Graph:
        """Capture the chain from the pool into a graph with a static input
        of ``x``'s signature (:func:`capture`)."""
        static_in = torch.empty(x.shape, dtype=x.dtype, device=self.device)
        static_in.copy_(x)
        graph, static_out, launches = capture(lambda: self._chain(static_in), self.pool,
                                              self.device)
        g = _Graph(graph, static_in, static_out, launches)
        self._graphs[(tuple(x.shape), x.dtype)] = g
        return g

    def __call__(self, x):
        return self.serve(x)

    @property
    def trace_count(self) -> int:
        """Captures on a card, staged signatures on the CPU or without
        graphs: one per distinct (shape, dtype) this plan has served. The serving tier
        snapshots it after warmup to hold its zero-retrace contract."""
        return len(self._graphs) + len(self._signatures)

    @property
    def replays(self) -> int:
        """Graph replays so far (the launch counters do not see them)."""
        return self._replays[0]

    @property
    def graph_launches(self) -> dict:
        """``{(shape, dtype): {kernel: launches}}`` of each captured graph:
        what one replay launches."""
        return {sig: dict(g.launches) for sig, g in self._graphs.items()}

    def check(self, params) -> None:
        if params_fingerprint(params) != self.fingerprint:
            raise StalePlanError(
                f"plan for {self.model!r} was built from a different state (the "
                "weights were re-quantized, re-compressed or re-calibrated after the "
                "plan was frozen): rebuild it with model.plan()")

    @property
    def tiles(self) -> dict:
        """Per-layer resolved tile plans."""
        return {l.name: dict(l.tiles) for l in self.layers if l.tiles}


def make_buckets(max_batch: int) -> Tuple[int, ...]:
    """The serving bucket ladder: powers of two up to the first bucket
    >= ``max_batch`` (``make_buckets(8) == make_buckets(5) == (1, 2, 4, 8)``)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = [1]
    while out[-1] < max_batch:
        out.append(out[-1] * 2)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class PlanSet:
    """A bucket ladder of frozen plans for one model.

    ``buckets`` is ascending and ``plans[b]`` is the :class:`ModelPlan`
    staged for batch ``b``. ``serve(x)`` takes any leading batch size: it
    chunks at the largest bucket, zero-pads each chunk up to the smallest
    bucket that fits, serves the bucket's plan and slices the padding off:
    equal to serving each request alone, with no new capture once every
    bucket is warm. Build with ``SparseCNN.plan_set()``.
    """

    model: str
    fingerprint: str
    buckets: Tuple[int, ...]
    plans: Mapping[int, ModelPlan]
    sample_spec: Optional[Tuple[Tuple[int, ...], str]] = None

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("PlanSet needs at least one bucket")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be ascending and unique: {self.buckets}")
        if set(self.plans) != set(self.buckets):
            raise ValueError(f"plans keyed {sorted(self.plans)} != buckets {self.buckets}")
        object.__setattr__(self, "plans", MappingProxyType(dict(self.plans)))

    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest bucket >= n, or None above the largest (``serve`` then
        chunks at the largest bucket)."""
        for b in self.buckets:
            if b >= n:
                return b
        return None

    def serve(self, x, *, put=None, on_dispatch=None, dispatch=None):
        """Bucketed serving of any batch size.

        A numpy ``x`` takes the host-assembly path the serving tier uses:
        chunk, pad and slice run in numpy, each padded chunk goes to its
        bucket's plan and the logits come back as numpy, so no glue op runs
        on the card. A tensor ``x`` is padded and sliced with torch ops
        and the logits stay on the plans' device.

        ``put`` (optional) maps each padded chunk to what the plan serves
        (default: ``torch.from_numpy`` on the host path).
        ``on_dispatch(bucket, n_real)`` observes each plan dispatch;
        ``dispatch(bucket, xb)`` replaces it. On the host path a chunk's
        copy in, dispatch and copy back hold :data:`GRAPH_LOCK`, so a
        capture on another thread never meets them.
        """
        n = x.shape[0]
        if n < 1:
            raise ValueError(f"empty batch: {tuple(x.shape)}")
        host = isinstance(x, np.ndarray)
        cap = self.buckets[-1]
        outs = []
        i = 0
        while i < n:
            take = min(cap, n - i)
            b = self.bucket_for(take)
            xb = x[i: i + take]
            if take < b:
                if host:
                    xb = np.pad(xb, [(0, b - take)] + [(0, 0)] * (x.ndim - 1))
                else:
                    xb = torch.cat([xb, xb.new_zeros((b - take,) + tuple(xb.shape[1:]))])
            if on_dispatch is not None:
                on_dispatch(b, take)
            with GRAPH_LOCK if host else contextlib.nullcontext():
                if put is not None:
                    xb = put(xb)
                elif host:
                    xb = torch.from_numpy(np.ascontiguousarray(xb))
                y = self.plans[b].serve(xb) if dispatch is None else dispatch(b, xb)
                if host:
                    y = y.cpu().numpy()
            outs.append(y if take == b else y[:take])
            i += take
        if len(outs) == 1:
            return outs[0]
        return np.concatenate(outs, axis=0) if host else torch.cat(outs)

    def __call__(self, x):
        return self.serve(x)

    def warmup(self, sample_shape=None, dtype="float32", *, put=None) -> int:
        """Capture every bucket once through the host-assembly path
        (``sample_shape`` is one sample without the batch, e.g. ``(H, W,
        C)``; by default the set's :attr:`sample_spec`). Returns
        :attr:`trace_count`; serving any batch size after this captures
        nothing new."""
        if sample_shape is None:
            if self.sample_spec is None:
                raise ValueError("warmup() needs sample_shape: this plan set has no sample_spec")
            sample_shape, dtype = self.sample_spec
        for b in self.buckets:
            self.serve(np.zeros((b,) + tuple(sample_shape), dtype), put=put)
        return self.trace_count

    @property
    def trace_count(self) -> int:
        """Captures (or staged signatures) across all buckets."""
        return sum(p.trace_count for p in self.plans.values())

    @property
    def tiles(self) -> dict:
        """Per-bucket per-layer resolved tile plans."""
        return {b: self.plans[b].tiles for b in self.buckets}

    def check(self, params) -> None:
        """Raise :class:`StalePlanError` unless ``params`` still matches the
        state every bucket's plan was frozen from."""
        if params_fingerprint(params) != self.fingerprint:
            raise StalePlanError(
                f"plan set for {self.model!r} was built from a different state (the "
                "weights were re-quantized, re-compressed or re-calibrated): rebuild it "
                "with model.plan_set()")


def fallback_closures(primary: PlanSet, fallback: PlanSet, *, verify: bool = True) -> dict:
    """Per-bucket closures for the serving tier's degradation,
    ``{bucket: serve}``, from a second :class:`PlanSet` staged from the
    same state (``SparseCNN.fallback_plan_set``: the same kernels, run
    without graphs). When a bucket's plan keeps failing, the server demotes
    that bucket alone to its closure here; every other bucket keeps its
    graphs.

    The two sets must share the state's fingerprint, the bucket ladder and
    the sample spec. With ``verify`` every bucket serves one seeded batch
    through both, and the outputs must be equal bit for bit (the
    reference's ``rtol=0``). The pass is also the fallback's warmup.
    """
    if primary.fingerprint != fallback.fingerprint:
        raise StalePlanError("fallback plan set was built from another state than the "
                             "primary: rebuild both from the same quantized weights")
    if tuple(primary.buckets) != tuple(fallback.buckets):
        raise ValueError(f"fallback buckets {fallback.buckets} != primary {primary.buckets}: "
                         "a demoted bucket keeps its ladder")
    if primary.sample_spec is not None and fallback.sample_spec != primary.sample_spec:
        raise ValueError(f"fallback sample spec {fallback.sample_spec} != primary "
                         f"{primary.sample_spec}")
    if verify:
        if primary.sample_spec is None:
            raise ValueError("verifying a fallback needs a sample_spec")
        shape, dtype = primary.sample_spec
        rng = np.random.default_rng(0)
        for b in primary.buckets:
            xb = rng.standard_normal((b,) + tuple(shape)).astype(dtype)
            yp, yf = primary.serve(xb), fallback.serve(xb)
            if not np.array_equal(yf, yp):
                err = float(np.abs(yf - yp).max())
                raise AssertionError(f"fallback bucket {b} is not bit-compatible with the "
                                     f"primary (max abs diff {err:.3e})")
    return {b: fallback.plans[b].serve for b in fallback.buckets}


def resolve_tune_cache(tune: str, cache=None, device=None):
    """Parse the autotune cache once per plan build, so nested builds
    (``plan_set`` → a plan per bucket) share one parse: a ``TuneCache`` (an
    already parsed one passes through) for ``'cache'`` and ``'search'`` on a
    card; ``cache`` as given for ``'off'`` and on the CPU, where nothing is
    read. Raises on an unknown mode."""
    from repro_torch.kernels import autotune

    autotune.check_mode(tune)
    if tune == "off" or (device is not None and torch.device(device).type != "cuda"):
        return cache
    return autotune.as_cache(cache)


class PlanBuilder:
    """Collects staged serving layers into an immutable :class:`ModelPlan`.

    One builder per (model, state, batch): the fingerprint is taken at
    construction, the tuning keywords are normalized once
    (:func:`resolve_tune_cache`), and every :meth:`stage` call hands
    ``tune``, ``cache``, ``top_k`` and ``reps`` to the layer's
    ``make_plan``. Stages without tiles (pooling) use :meth:`raw`.
    ``device`` is where the staged tensors lie, and it has no default: a
    plan told the CPU around card tensors would replay nothing.
    """

    def __init__(self, model: str, params, *, batch: Optional[int] = None, tune: str = "cache",
                 cache=None, top_k: int = 4, reps: int = 3,
                 sample_spec: Optional[Tuple[Tuple[int, ...], str]] = None, device,
                 pool: Optional[GraphPool] = None, graphs: bool = True):
        self.model = model
        self.graphs = graphs
        self.batch = batch
        self.sample_spec = sample_spec
        self.device = torch.device(device)
        self.pool = pool
        self.fingerprint = params_fingerprint(params)
        self.tune = tune
        self.cache = resolve_tune_cache(tune, cache, self.device)
        self.top_k = top_k
        self.reps = reps
        self._stages: list = []

    @property
    def tune_kw(self) -> dict:
        """The tuning keywords every ``make_plan`` receives."""
        return dict(tune=self.tune, cache=self.cache, top_k=self.top_k, reps=self.reps)

    def stage(self, name: str, kind: str, make_plan: Callable, *args, **kw):
        """Stage one layer through its ``make_plan(*args, **kw, **tune_kw)``
        -> ``(run, tiles)``. Returns self."""
        run, tiles = make_plan(*args, **kw, **self.tune_kw)
        self._stages.append(LayerPlan(name, kind, tuple(sorted(tiles.items())), run))
        return self

    def raw(self, name: str, kind: str, run: Callable):
        """Stage a closure without tiles (its tensors already frozen in)."""
        self._stages.append(LayerPlan(name, kind, (), run))
        return self

    def build(self) -> ModelPlan:
        if not self._stages:
            raise ValueError("PlanBuilder has no stages")
        return ModelPlan(self.model, self.fingerprint, tuple(self._stages), self.batch,
                         self.sample_spec, self.device, self.pool, self.graphs)


def build_plan_set(model: str, params, plan_for_batch: Callable[[int], ModelPlan], *,
                   max_batch: Optional[int] = None, buckets=None) -> PlanSet:
    """Bucket-ladder :class:`PlanSet` from a per-batch plan factory: the
    powers of two of :func:`make_buckets` when ``buckets`` is None, one plan
    per bucket from ``plan_for_batch(b)``, pinned to ``params``."""
    if buckets is None:
        if max_batch is None:
            raise ValueError("plan set needs max_batch or explicit buckets")
        buckets = make_buckets(max_batch)
    buckets = tuple(sorted({int(b) for b in buckets}))
    bad = [b for b in buckets if b < 1]
    if bad:
        raise ValueError(f"buckets {bad} are not positive")
    plans = {b: plan_for_batch(b) for b in buckets}
    spec = next((p.sample_spec for p in plans.values() if p.sample_spec is not None), None)
    return PlanSet(model, params_fingerprint(params), buckets, plans, spec)
