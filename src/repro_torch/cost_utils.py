"""What one call of the port costs, counted on the ops it executes (the
counterpart of the cost half of ``repro/xla_utils.py``; its timing half is
``kernels/timing.py``).

The reference reads XLA's ``cost_analysis`` of the compiled per-device SPMD
program. The port runs eagerly, so :class:`CostCounter` counts the aten ops
one rank dispatches on its local tensors:

  - under DTensor it lets every DTensor-level op pass and counts the local
    ops DTensor runs beneath it, on the local shapes (``FlopCounterMode``
    above DTensor would count the global product; an op DTensor's sharding
    propagation runs on global shapes to infer metadata is not counted);
  - ``flops`` by ``torch.utils.flop_counter``'s formulas; a compressed
    projection (the tc or bw matmul wrapper) at ``2·M·K_c·N``, as
    ``core/vdbb.py:dbb_gemm_costs`` has it, once, whether its kernel or its
    plain version runs beneath;
  - ``bytes accessed``: every counted op's input plus output bytes (views
    move none), an upper bound with no fusion;
  - ``transcendentals``: the output elements of exp, log, tanh, the
    trigonometric and reciprocal-root ops;
  - collectives: each ``c10d`` and ``_c10d_functional`` op by kind, with its
    output's local bytes (the reference sums result-shape bytes);
  - ``peak_bytes``: the most bytes the op outputs held live at once (each
    storage from its first output until it is freed), the activation peak
    of the counted call.

It works on ``meta`` tensors (nothing allocated; a compressed product's
shape comes from the kernel's plain version there) as on real ones.
"""
from __future__ import annotations

import collections
import contextlib
import sys
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_COLL_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_UNCOUNTED = {"wait_tensor", "_wrap_tensor_autograd"}
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log_softmax", "_log_softmax",
                   "softmax", "_softmax", "tanh", "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf",
                   "pow", "silu", "gelu", "logsumexp", "reciprocal"}
_PROPAGATION = ("_sharding_prop.py",)  # DTensor infers output metadata here, on global shapes


def _tensors(tree) -> list:
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            out += _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            out += _tensors(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class CostCounter(TorchDispatchMode):
    """Counts what this rank executes while it is installed (``with
    CostCounter() as c: step()``); :meth:`record` gives the totals."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.ops: collections.Counter = collections.Counter()
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_largest = 0  # the bytes of the largest single collective's output
        self.coll_shapes: list = []  # (kind, output shape) of each collective, in order
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: dict = {}
        self._paused = 0

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs its local ops, which come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused and not _in_propagation():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        name = func._opname if hasattr(func, "_opname") else str(func)
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional", "c10d_functional"):
            if name in _UNCOUNTED:
                return
            kind = _COLL_KIND.get(name, name)
            outs = _tensors(out) if ns != "c10d" else _tensors(args[0] if args else ())
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            n = sum(map(_nbytes, outs))
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + n
            self.coll_largest = max(self.coll_largest, n)
            self.coll_shapes += [(kind, tuple(t.shape)) for t in outs]
            return
        self.ops[str(func)] += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if not func.is_view:
            self.bytes_accessed += sum(map(_nbytes, _tensors(args) + _tensors(kwargs) + outs))
        for t in outs:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    # ------------------------------------------------- compressed products
    def add_product(self, a, values, indices, out) -> None:
        """One compressed projection: ``2·M·K_c·N`` FLOPs and its operands'
        and output's bytes."""
        m = a.numel() // a.shape[-1]
        kc = values.shape[0] * values.shape[1]
        self.flops += 2 * m * kc * values.shape[-1]
        self.bytes_accessed += sum(map(_nbytes, (a, values, indices, out)))
        self.ops["vdbb_matmul"] += 1
        self._track(out)

    @contextlib.contextmanager
    def products(self):
        """Route the tc and bw matmul wrappers through :meth:`add_product`,
        their insides uncounted. A ``meta`` operand carries no data, so its
        product runs the kernel's plain version for the output's shape (the
        reference's ``kernel_mode='ref'`` in a dry run; nothing is
        launched); any other goes to the wrapper as it is."""
        from repro_torch.kernels import vdbb_matmul as vm

        saved = vm.vdbb_matmul_tc, vm.vdbb_matmul_bw

        def counted(fn, plain):
            def run(a, values, indices, fmt, choice=None, **kw):
                self._paused += 1
                try:
                    out = (plain(a, values, indices, fmt, **kw) if a.device.type == "meta"
                           else fn(a, values, indices, fmt, choice=choice, **kw))
                finally:
                    self._paused -= 1
                self.add_product(a, values, indices, out)
                return out
            return run

        vm.vdbb_matmul_tc = counted(saved[0], vm.vdbb_matmul_tc_plain)
        vm.vdbb_matmul_bw = counted(saved[1], vm.vdbb_matmul_bw_plain)
        try:
            yield self
        finally:
            vm.vdbb_matmul_tc, vm.vdbb_matmul_bw = saved

    # ------------------------------------------------------------- results
    def record(self) -> dict:
        coll_total = sum(self.coll_bytes.values())
        return {
            "flops": self.flops, "bytes accessed": self.bytes_accessed,
            "transcendentals": self.transcendentals, "peak_bytes": self.peak_bytes,
            "collectives": {"bytes": dict(self.coll_bytes), "counts": dict(self.coll_counts),
                            "total_bytes": coll_total, "largest_bytes": self.coll_largest,
                            # torch keeps bf16 collectives in bf16 (the reference's
                            # XLA CPU backend upcast them to fp32): the same bytes
                            "tpu_equiv_total_bytes": coll_total},
        }


@contextlib.contextmanager
def counting():
    """``with counting() as c:`` a :class:`CostCounter` with the compressed
    projections routed through it."""
    c = CostCounter()
    with c.products(), c:
        yield c


def cost_analysis_dict(fn, *args, **kwargs) -> dict:
    """The cost of one call ``fn(*args, **kwargs)`` on this rank (the
    counterpart of the reference's normalized ``Compiled.cost_analysis()``):
    ``flops``, ``bytes accessed``, ``transcendentals``, the activation
    ``peak_bytes`` and ``collectives``, by :class:`CostCounter`."""
    with counting() as c:
        fn(*args, **kwargs)
    return c.record()


def op_breakdown(fn, *args, profile: bool = False, **kwargs) -> dict:
    """Where a call's work goes (the counterpart of ``hlo_op_breakdown``):
    ``ops``, the count of each aten op it dispatched on local tensors,
    ``n_ops``, and :func:`cost_analysis_dict`'s ``flops`` and ``bytes
    accessed``. With ``profile`` (a card) the call runs once more under
    ``torch.profiler`` and ``kernels`` counts the CUDA kernels it launched,
    by name, and ``n_kernels`` their launches (device-side copies of spans
    left out: :func:`repro_torch.spans.is_span`)."""
    with counting() as c:
        fn(*args, **kwargs)
    out = {"ops": dict(c.ops), "n_ops": int(sum(c.ops.values())), "flops": c.flops,
           "bytes_accessed": c.bytes_accessed}
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        from repro_torch.spans import is_span

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*args, **kwargs)
            torch.cuda.synchronize()
        kernels = collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not is_span(e))
        out["kernels"] = dict(kernels)
        out["n_kernels"] = int(sum(kernels.values()))
    return out
