"""Closed loop of batched greedy generation: each call is
``launch/serve.py:generate(model, prompts, gen_len, max_len, prefill_reps=1,
graph=True)`` on a new seeded batch of ``batch`` prompts of ``prompt_len``
tokens, as a user of the port calls it; the next call starts when it
returns. The window ends with the call that crosses ``--seconds``.

Traffic keys: ``batch``, ``prompt_len``, ``gen_len``, ``max_len``,
``keep_steps`` (decode steps whose logits ``generate`` keeps for the
comparison), ``check_sequences`` (sequences sampled for it),
``trace_seconds``. Faults (tests only): ``answer`` (one served token
changed where it is produced), ``half_batch`` (the second half of the batch
served the first half's tokens), ``stale_state`` (the decode step's cache
write dropped: the state returned unchanged).
"""
from __future__ import annotations

import contextlib
import time

import torch

from portbench.lib import program, weights
from portbench.lib.compare import rel_max_err, widest_gap
from portbench.lib.harness import sync
from portbench.lib.sample import pick
from portbench.lib.stats import rate


@contextlib.contextmanager
def stale_state():
    """Every cache write of the decode step dropped."""
    from repro_torch.models import attention

    keep = attention.write_slot_
    attention.write_slot_ = lambda buf, slot, new: None
    try:
        yield
    finally:
        attention.write_slot_ = keep


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.b, self.p, self.g, self.cap = t["batch"], t["prompt_len"], t["gen_len"], t["max_len"]

    def _prompts(self, call):
        return weights.lm_tokens(self.ctx.config, self.ctx.seed, ("call", call), self.b, self.p,
                                 self.ctx.device)

    def _generate(self, prompts, keep=()):
        from repro_torch.launch.serve import generate

        faults = self.ctx.faults
        if "half_batch" in faults:
            prompts = prompts.clone()
            prompts[self.b // 2:] = prompts[: self.b - self.b // 2]
        with stale_state() if "stale_state" in faults else contextlib.nullcontext():
            rec = generate(self.model, {"tokens": prompts}, gen_len=self.g, max_len=self.cap,
                           keep=keep, prefill_reps=1, graph=True)
        if "answer" in faults:
            rec["tokens"][0, self.g // 2] += 1
        return rec

    def setup(self):
        self.model = program.build_lm(self.ctx.config, self.ctx.seed, self.ctx.device)
        self._generate(self._prompts("warm"))  # the cell's shapes, built and warm
        sync(self.ctx.device)

    def window(self, seconds: float, span) -> dict:
        keep = tuple(self.ctx.traffic["keep_steps"])
        calls = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            prompts = self._prompts(len(calls))
            tc = time.perf_counter()
            if span is None:
                rec = self._generate(prompts, keep)
            else:
                with span("portbench.generate"):
                    rec = self._generate(prompts, keep)
            sync(self.ctx.device)
            calls.append({"tokens": rec["tokens"], "logits": rec["logits"],
                          "prefill_ms": rec["prefill_ms"], "ms_per_step": rec["ms_per_step"],
                          "forwards": dict(rec["forwards"]), "captures": rec["captures"],
                          "wall_s": time.perf_counter() - tc})
        elapsed = time.perf_counter() - t0
        self.calls = calls
        tokens = len(calls) * self.b * self.g
        per_call = "; ".join(f"{c['wall_s']:.4f} s, {c['prefill_ms']:.3f} + "
                             f"{self.g - 1} x {c['ms_per_step']:.4f} ms" for c in calls)
        return {"e2e": {"gen_tokens_per_s": rate(tokens, elapsed)}, "attempted": len(calls) * self.b,
                "failed": 0, "calls": calls, "window_s": elapsed,
                "info": [f"{len(calls)} generate calls of {self.b} x ({self.p} + {self.g}) "
                         f"tokens in {elapsed:.6f} s; per call: wall, and generate's own "
                         f"prefill + steps x ms per step (CUDA events): {per_call}"]}

    def free(self):
        self.model = None
        for c in self.calls:
            c["tokens"] = c["tokens"].cpu()
            c["logits"] = {i: v.cpu() for i, v in c["logits"].items()}

    def check(self, control: bool = False) -> list:
        """A seeded sample of the window's sequences, each prompt with its
        served tokens run once through the float32 reference: the widest gap
        of a served token below the reference's best, and the kept decode
        logits against the reference's at their positions. ``control``: the
        reference in fp8 in the program's place, at the same prompts and
        tokens: the gap of the token it puts first, and its logits at the
        kept positions."""
        lim, dev = self.ctx.limits, self.ctx.device
        pairs = [(c, r) for c in range(len(self.calls)) for r in range(self.b)]
        pairs = pick(self.ctx.seed, "sequences", pairs, self.ctx.traffic["check_sequences"])
        seqs, served = [], []
        for c, r in pairs:
            tok = self.calls[c]["tokens"][r].to(dev)
            seqs.append(torch.cat([self._prompts(c)[r], tok[:-1]]))
            served.append(tok)
        logits = self.ctx.cell.reference.forward(self.ctx.config, self.ctx.seed,
                                                 torch.stack(seqs))
        p = self.p
        low = None
        if control:
            low = self.ctx.cell.reference.forward(self.ctx.config, self.ctx.seed,
                                                  torch.stack(seqs), "fp8")
            served = list(low[:, p - 1:].argmax(dim=-1))
        gap = widest_gap(logits[:, p - 1:], torch.stack(served))
        got, want = [], []
        for j, (c, r) in enumerate(pairs):
            for i, lg in self.calls[c]["logits"].items():
                got.append(low[j, p + i] if control else lg[r, 0].float())
                want.append(logits[j, p + i])
        err = rel_max_err(torch.stack(got), torch.stack(want))
        return [{"name": "token_gap", "value": gap, "limit": lim["token_gap"]},
                {"name": "kept_logit_err", "value": err, "limit": lim["kept_logit_err"]}]
