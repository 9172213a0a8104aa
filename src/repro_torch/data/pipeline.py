"""Deterministic synthetic token pipeline, per-host sharded and resumable
(port of ``repro/data/pipeline.py``: numpy, as the reference, so a batch is
the reference's bit for bit).

Production posture: the pipeline is a pure function of (seed, step, host
slice), so restart/elastic-reshard reproduce the exact stream with no
state files; the checkpoint only stores the step counter. A background
prefetch thread keeps ``batches_ahead`` batches ready (straggler hiding).

The synthetic stream is a mixture of Zipf-distributed tokens with shifted
copies, giving next-token structure a model can actually learn (used by
the convergence tests and examples).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 1234
    zipf_a: float = 1.3
    copy_period: int = 7  # t ~ t-copy_period correlation -> learnable
    batches_ahead: int = 2
    host_index: int = 0
    host_count: int = 1


class SyntheticTokens:
    """Stateless-by-construction data source: batch(step) is pure."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        if dcfg.global_batch % dcfg.host_count:
            raise ValueError(f"global_batch {dcfg.global_batch} does not split over "
                             f"{dcfg.host_count} hosts")
        self.local_batch = dcfg.global_batch // dcfg.host_count
        self.vocab = cfg.codebook_vocab if cfg.frontend == "audio" else cfg.vocab_size

    def batch(self, step: int) -> dict:
        d = self.dcfg
        rng = np.random.default_rng(
            np.random.SeedSequence([d.seed, step, d.host_index])
        )
        b, s = self.local_batch, d.seq_len
        shape = (b, s + 1, self.cfg.num_codebooks) if self.cfg.frontend == "audio" else (b, s + 1)
        z = rng.zipf(d.zipf_a, size=shape)
        toks = np.minimum(z, self.vocab - 1).astype(np.int32)
        # plant copy structure: token[t] = token[t-p] on even phases
        p = d.copy_period
        toks[:, p::p] = toks[:, : toks.shape[1] - p : p]
        out = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "loss_mask": np.ones((b, s), np.float32),
        }
        if self.cfg.frontend == "vision":
            out["vision_embeds"] = (
                0.02 * rng.standard_normal((b, self.cfg.num_vision_tokens, self.cfg.d_model))
            ).astype(np.float32)
        if self.cfg.cross_attn:
            out["memory"] = (
                0.02 * rng.standard_normal((b, self.cfg.cross_len, self.cfg.d_model))
            ).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of the (CPU-bound) batch synthesis."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0, depth: Optional[int] = None):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth or source.dcfg.batches_ahead)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.source.batch(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
