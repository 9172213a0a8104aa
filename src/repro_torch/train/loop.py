"""Fault-tolerant training loop (port of ``repro/train/loop.py``).

- auto-resume: restores the latest verified checkpoint (params, optimizer
  state, data step) on start, so a killed or preempted job relaunched with
  the same directory continues where it stopped;
- preemption: SIGTERM and SIGINT flush a checkpoint of the step in flight
  and end the loop (the handlers are the loop's while it runs);
- checkpoints are written by ``AsyncCheckpointer`` (the copy to the host in
  the loop, the write on a thread); the data pipeline prefetches on a host
  thread.

The step runs eagerly (``train/step.py``); the reference's ``jit_kwargs``
have no counterpart, and ``run(generator=)`` takes the place of its ``key``.

On a mesh (``mesh=`` and ``rules=``, ``launch/train.py --distributed``)
the parameters are drawn leaf by leaf and distributed by ``LM.pspecs``, the
optimizer state takes their placements, every rank draws the same global
batch from the pipeline and keeps its slice along the batch axes (nothing
is broadcast), and each step runs under ``sharding_rules(rules, mesh)``.
A resume restores each leaf onto the mesh the job has now
(``store.restore(shardings=)``), whatever mesh saved it. Without a mesh
``restore`` lays every leaf on the model's device.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import store
from repro_torch.core.sparse_linear import PruneSchedule
from repro_torch.models.common import distribute, named_shardings, sharding_rules
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticTokens
from repro_torch.models.model import LM
from repro_torch.optim.adamw import OptConfig, init_state
from repro_torch.train.step import make_train_step, to_device


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    keep: int = 3


class Trainer:
    """Trains ``model`` on :class:`SyntheticTokens` on ``device`` (``cuda``
    unless the caller asks for another, :func:`repro_torch.resolve_device`),
    sharded over ``mesh`` by ``rules`` when both are given. ``data_wait_s``
    keeps, per step run, the host seconds the loop waited for its batch."""

    def __init__(self, model: LM, opt_cfg: OptConfig, data_cfg: DataConfig, loop_cfg: LoopConfig,
                 prune_schedule: Optional[PruneSchedule] = None, device=None, mesh=None,
                 rules: Optional[dict] = None):
        if (mesh is None) != (rules is None):
            raise ValueError("a mesh needs its rules, and rules their mesh")
        self.mesh, self.rules = mesh, rules
        self.model = model
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.loop = loop_cfg
        self.device = resolve_device(device)
        self.source = SyntheticTokens(model.cfg, data_cfg)
        self.step_fn = make_train_step(model, opt_cfg, prune_schedule)
        self.ckpt = (store.AsyncCheckpointer(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
                     if loop_cfg.ckpt_dir else None)
        self.data_wait_s: list = []
        self._preempted = False

    # ------------------------------------------------------------------
    def init_or_resume(self, generator: Optional[torch.Generator] = None):
        """Seeded parameters (``generator``, else seed 0, drawn on the
        device), projected onto the DBB constraint, and a fresh optimizer
        state; or, when the checkpoint directory holds a step, that step's
        state and the step after it. Returns ``(params, opt_state, start)``."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.model.init(generator, self.device, mesh=self.mesh, rules=self.rules)
        if self.model.cfg.dbb is not None:
            self.model.constrain()
        params = self.model.params
        opt_state = init_state(params, self.opt_cfg)
        start = 0
        if self.loop.ckpt_dir and store.latest_step(self.loop.ckpt_dir) is not None:
            sh = None
            if self.mesh is not None:  # onto this job's mesh, whatever mesh saved it
                specs = self.model.pspecs(self.rules)
                sh = (named_shardings(specs, self.mesh),
                      {k: named_shardings(() if k == "count" else specs, self.mesh)
                       for k in opt_state})
            (params, opt_state), manifest = store.restore(self.loop.ckpt_dir, (params, opt_state),
                                                          device=self.device, shardings=sh)
            self.model.load_params(params)
            start = manifest["step"] + 1
            print(f"[resume] from step {manifest['step']}")
        return params, opt_state, start

    def _step(self, params, opt_state, batch: dict, step: int):
        """One train step; on a mesh each rank keeps its slice of the global
        batch along the batch axes (the tokens also along the sequence, on
        'model') and the step runs under the rules."""
        if self.mesh is None:
            return self.step_fn(params, opt_state, batch, step)
        dp = self.rules["batch"]
        # tokens along the sequence too, on 'model': the sequence-parallel
        # residual's layout, as the reference's dryrun feeds them
        batch = {k: distribute(v, self.mesh, (dp, "model" if k == "tokens" else None)
                               + (None,) * (v.dim() - 2))
                 for k, v in batch.items()}
        with sharding_rules(self.rules, self.mesh):
            return self.step_fn(params, opt_state, batch, step)

    def _install_signal_handlers(self) -> dict:
        """Route SIGTERM and SIGINT to a flag the loop reads; returns the
        handlers they replace (none off the main thread)."""
        def handler(signum, frame):
            self._preempted = True

        old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread (tests)
        return old

    # ------------------------------------------------------------------
    def run(self, params=None, opt_state=None, start_step=None, generator=None):
        """Train from ``params`` / ``opt_state`` at ``start_step`` (a tree on
        the device, e.g. another package's parameters), else from
        :meth:`init_or_resume` (``generator`` seeds a fresh start), to
        ``total_steps``. Returns ``(params, opt_state, history)``, history
        the ``(step, loss)`` of every logged step."""
        if params is None:
            params, opt_state, start_step = self.init_or_resume(generator)
        else:
            self.model.load_params(params)
        handlers = self._install_signal_handlers()
        pf = Prefetcher(self.source, start_step=start_step)
        history = []
        t0 = time.time()
        try:
            for _ in range(start_step, self.loop.total_steps):
                t_wait = time.perf_counter()
                step, batch = pf.next()
                self.data_wait_s.append(time.perf_counter() - t_wait)
                params, opt_state, metrics = self._step(params, opt_state,
                                                        to_device(batch, self.device), step)
                if step % self.loop.log_every == 0 or step == self.loop.total_steps - 1:
                    loss = float(metrics["loss"])
                    history.append((step, loss))
                    rate = (step - start_step + 1) / (time.time() - t0)
                    if store.is_writer():
                        print(f"step {step:6d} loss {loss:.4f} ({rate:.2f} it/s)", flush=True)
                if self.ckpt and ((step > 0 and step % self.loop.ckpt_every == 0)
                                  or self._preempted):
                    self.ckpt.save_async(step, (params, opt_state))
                if self._preempted:
                    print(f"[preempt] flushed checkpoint at step {step}; exiting")
                    break
        finally:
            pf.stop()
            if self.ckpt:
                self.ckpt.wait()
            for sig, h in handlers.items():
                signal.signal(sig, h)
        return params, opt_state, history
