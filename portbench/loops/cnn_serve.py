"""Closed loop, one client, batches of images classified from the card:
every request is one batch of ``batch`` seeded images (NHWC float32,
already normalised; a pool of ``pool_batches`` batches made on the card at
set-up, taken in turn) served through the bucketed plan set of the INT8
chain, ``SparseCNN.plan_set(buckets=(batch,), tune="off")``, by
``PlanSet.serve``, after calibrating on ``calib_batches`` other batches
(``SparseCNN.quantize`` on the stats of one float32 forward over them). A
request ends when its logits (batch × classes, float32) are on the host, in
pinned memory as a server's output buffer would hold them.

The program is built from the configuration file's keys (``CNNConfig``'s
fields), its weights from ``portbench.lib.cnn_weights``.

Traffic keys: ``batch``, ``pool_batches``, ``calib_batches``,
``check_requests``, ``trace_seconds``. Faults (tests only): ``answer``
(every answer's first logit moved by the answer's root mean square).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from portbench.lib.cnn_weights import cnn_conv, cnn_head, cnn_images, cnn_layout
from portbench.lib.compare import rel_max_err
from portbench.lib.harness import sync
from portbench.lib.sample import Reservoir
from portbench.lib.stats import quantile, rate

# the launch counters' names of one replay's kernels, as the info line gives them
COUNTED = ("im2col_conv", "im2col_conv_maxpool", "vdbb_conv_tc", "vdbb_conv_tc_residual",
           "vdbb_matmul_tc")


def cnn_config(cfg: dict):
    """The program's ``CNNConfig`` from the configuration's keys."""
    from repro_torch.core.vdbb import DBBFormat
    from repro_torch.models.cnn import CNNConfig

    if cfg["stem_padding"] != cfg["stem_kernel"] // 2:
        raise ValueError("the program pads the stem by half its kernel on each side")
    fields = {f.name for f in dataclasses.fields(CNNConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()
          if k in fields and k != "dbb"}
    d = cfg["dbb"]
    return CNNConfig(dbb=DBBFormat(d["bz"], d["nnz"], d["pattern"]), **kw)


def build_cnn(cfg: dict, seed: int, device):
    """A ``SparseCNN`` holding the benchmark's weights, every compressed layer
    compressed. The program's layers ``l0 … lN`` are the layout's convs in
    its order, then the head; each shape is checked against the layout."""
    from repro_torch.models.cnn import SparseCNN

    model = SparseCNN(cnn_config(cfg))
    layers = model.layers()
    layout = cnn_layout(cfg)
    if len(layout) + 1 != len(layers):
        raise ValueError(f"{len(layout)} convs in the layout, {len(layers) - 1} in the program")
    tree = {}
    for i, (layer, m) in enumerate(zip(layout, layers)):
        got = (m.kh, m.in_channels, m.out_channels, m.stride[0], m.padding[0][0])
        want = (layer["k"], layer["cin"], layer["cout"], layer["stride"], layer["pad"])
        if got != want:
            raise ValueError(f"l{i} ({layer['name']}): the program's {got}, the layout's {want}")
        tree[f"l{i}"] = cnn_conv(cfg, seed, layer, device)
    tree[f"l{len(layout)}"] = cnn_head(cfg, seed, device)
    return model.load_state(tree).compress()


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.b = ctx.traffic["batch"]

    def _images(self, tag, n):
        return cnn_images(self.ctx.config, self.ctx.seed, tag, n, self.ctx.device)

    def setup(self):
        c, t, dev = self.ctx.config, self.ctx.traffic, self.ctx.device
        model = build_cnn(c, self.ctx.seed, dev)
        with torch.no_grad():
            _, stats = model(self._images("calib", t["calib_batches"] * self.b),
                             collect_act_stats=True)
        model.quantize(stats)
        self.model = model
        self.plans = model.plan_set(buckets=(self.b,), tune="off")
        self.pool = [self._images(("pool", i), self.b) for i in range(t["pool_batches"])]
        self.spare = []  # pinned logits buffers, reused
        for i in range(2):  # captured, then warm
            y = self._serve(self.pool[i])
        if dev.type == "cuda":
            self.spare.append(y)
        sync(dev)

    def _serve(self, x):
        return self._land(self.plans.serve(x))

    def _land(self, y):
        """The logits ``y`` on the host: on a card, copied into a pinned
        buffer, as a server's output buffer would hold them (one the sample
        did not keep, else a new one), once the copy is done."""
        if y.device.type == "cuda":
            host = self.spare.pop() if self.spare else torch.empty(
                y.shape, dtype=y.dtype, pin_memory=True)
            host.copy_(y, non_blocking=True)
            torch.cuda.current_stream(y.device).synchronize()
            y = host
        if "answer" in self.ctx.faults:
            y[:, 0] += y.pow(2).mean().sqrt()
        return y

    def window(self, seconds: float, span) -> dict:
        """Requests back to back. Each request's bookkeeping (its latency,
        the sample, its buffer back to the spares) waits until the next
        request is on the card, so that the card's gap between requests
        holds only the host's work for the request itself."""
        t = self.ctx.traffic
        keep = Reservoir(t["check_requests"], self.ctx.seed, "answers")
        pool, lat, n, last = self.pool, [], 0, None
        pinned = self.ctx.device.type == "cuda"

        def book(i, dt, y):
            lat.append(dt)
            keep.offer(i, y)
            if pinned and not any(v is y for _, v in keep.items):
                self.spare.append(y)

        clock = time.perf_counter
        t0 = clock()
        while True:
            ts = clock()
            if ts - t0 >= seconds:
                break
            x = pool[n % len(pool)]
            with span("portbench.request") if span is not None else contextlib.nullcontext():
                y = self.plans.serve(x)
                if last is not None:
                    book(*last)
                y = self._land(y)
            last = (n, clock() - ts, y)
            n += 1
        elapsed = clock() - t0
        if last is not None:
            book(*last)
        self.kept = keep.items
        ms = [v * 1e3 for v in lat]
        graphs = self.plans.plans[self.b].graph_launches
        launches = next(iter(graphs.values())) if graphs else {}
        return {"e2e": {"prefill_ms": 1e3 / rate(n, elapsed)}, "attempted": n, "failed": 0,
                "requests": n, "window_s": elapsed,
                "info": [f"{n} requests of {self.b} images in {elapsed:.6f} s "
                         f"({self.b * n / elapsed:.3f} images/s); per request (host clock, "
                         f"information only) p50 {quantile(ms, 0.5):.6f} ms, p95 "
                         f"{quantile(ms, 0.95):.6f} ms",
                         "one replay launches " + (", ".join(
                             f"{launches.get(k, 0)} {k}" for k in COUNTED) if graphs
                             else "nothing: no graph on this device")]}

    def free(self):
        self.model = self.plans = None

    def program_amax(self) -> dict:
        """The program's own calibrated scales under the names the
        reference's ``calibrate`` gives them, {name: scale · 127}: each
        conv's input scale, each projection's output scale, the head's."""
        layers = self.model.layers()
        out = {"head": float(layers[-1].aq) * 127}
        for m, c in zip(layers[1:], cnn_layout(self.ctx.config)[1:]):
            if c["name"].endswith(".proj"):
                out[c["name"] + ".out"] = float(m.oq) * 127
            else:
                out[c["name"]] = float(m.aq) * 127
        return out

    def check(self, control: bool = False, amax=None) -> list:
        """The sampled answers against the reference's INT8 path, its scales
        calibrated again on the same calibration images, or ``amax`` (as
        :meth:`program_amax` gives them) when given (``control``: the
        reference's INT4 path in the program's place)."""
        c, t = self.ctx.config, self.ctx.traffic
        ref = self.ctx.cell.reference
        if amax is None:
            amax = ref.calibrate(c, self.ctx.seed,
                                 self._images("calib", t["calib_batches"] * self.b))
        idx = sorted({n % t["pool_batches"] for n, _ in self.kept})
        want, low = {}, {}
        for i in idx:
            x = self._images(("pool", i), self.b)
            want[i] = ref.forward(c, self.ctx.seed, x, "int8", amax)
            if control:
                low[i] = ref.forward(c, self.ctx.seed, x, "int4", amax)
        pick = low if control else None
        got = torch.stack([pick[n % t["pool_batches"]] if control else y for n, y in self.kept])
        err = rel_max_err(got, torch.stack([want[n % t["pool_batches"]] for n, _ in self.kept]))
        return [{"name": "logit_err", "value": err, "limit": self.ctx.limits["logit_err"]}]
