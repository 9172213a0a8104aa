"""Closed loop, one client, long prompts scored for their first token: every
request is one seeded prompt of ``seq`` tokens (a pool of ``pool_prompts``
made on the card at set-up, cycled) served by a frozen INT8 plan,
``LM.plan(batch=1, seq=seq, tune="off")``, after one calibrating forward of
``calib_prompts`` other prompts (``LM.quantize`` on its stats). A request
ends when its last position's logits are on the host.

Traffic keys: ``seq``, ``pool_prompts``, ``calib_prompts``,
``check_requests``, ``trace_seconds``. Faults (tests only): ``answer``
(every answer's first logit moved by one).
"""
from __future__ import annotations

import time

import torch

from portbench.lib import program, weights
from portbench.lib.compare import rel_max_err
from portbench.lib.harness import sync
from portbench.lib.sample import Reservoir
from portbench.lib.stats import quantile, rate


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.s = ctx.traffic["seq"]

    def _tokens(self, tag, n):
        return weights.lm_tokens(self.ctx.config, self.ctx.seed, tag, n, self.s, self.ctx.device)

    def setup(self):
        c, t, dev = self.ctx.config, self.ctx.traffic, self.ctx.device
        model = program.build_lm(c, self.ctx.seed, dev)
        with torch.no_grad():
            _, stats = model.forward(self._tokens("calib", t["calib_prompts"]),
                                     collect_act_stats=True)
        model.quantize(stats)
        self.model = model
        self.plan = model.plan(batch=1, seq=self.s, tune="off")
        self.pool = self._tokens("pool", t["pool_prompts"])
        for i in range(2):  # captured, then warm
            self._serve(self.pool[i:i + 1])
        sync(dev)

    def _serve(self, x):
        y = self.plan(x)[0, -1].float().cpu()
        if "answer" in self.ctx.faults:
            y[0] += 1.0
        return y

    def window(self, seconds: float, span) -> dict:
        t = self.ctx.traffic
        keep = Reservoir(t["check_requests"], self.ctx.seed, "answers")
        pool, lat, n = self.pool, [], 0
        clock = time.perf_counter
        t0 = clock()
        while clock() - t0 < seconds:
            i = n % len(pool)
            ts = clock()
            if span is None:
                y = self._serve(pool[i:i + 1])
            else:
                with span("portbench.request"):
                    y = self._serve(pool[i:i + 1])
            lat.append(clock() - ts)
            keep.offer(n, y)
            n += 1
        elapsed = clock() - t0
        self.kept = keep.items
        ms = [v * 1e3 for v in lat]
        return {"e2e": {"prefill_ms": 1e3 / rate(n, elapsed)}, "attempted": n, "failed": 0,
                "requests": n, "window_s": elapsed,
                "info": [f"{n} prefills of 1 x {self.s} tokens in {elapsed:.6f} s; per "
                         f"request (host clock, information only) p50 "
                         f"{quantile(ms, 0.5):.6f} ms, p95 {quantile(ms, 0.95):.6f} ms"]}

    def free(self):
        self.model = self.plan = None

    def check(self, control: bool = False) -> list:
        """The sampled answers against the reference's INT8 path, its scales
        calibrated again on the same calibration prompts (``control``: the
        reference's INT4 path in the program's place)."""
        c, t = self.ctx.config, self.ctx.traffic
        ref = self.ctx.cell.reference
        amax = ref.calibrate(c, self.ctx.seed, self._tokens("calib", t["calib_prompts"]))
        pool = self._tokens("pool", t["pool_prompts"])
        idx = sorted({n % len(pool) for n, _ in self.kept})
        want = dict(zip(idx, ref.forward(c, self.ctx.seed, pool[idx], "int8", amax,
                                         last_only=True)))
        if control:
            low = dict(zip(idx, ref.forward(c, self.ctx.seed, pool[idx], "int4", amax,
                                            last_only=True)))
            got = torch.stack([low[n % len(pool)] for n, _ in self.kept])
        else:
            got = torch.stack([y for _, y in self.kept])
        err = rel_max_err(got, torch.stack([want[n % len(pool)] for n, _ in self.kept]))
        return [{"name": "logit_err", "value": err, "limit": self.ctx.limits["logit_err"]}]
