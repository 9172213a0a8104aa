"""Deterministic fault injection for the serving tier (port of
``repro/launch/faults.py``).

A :class:`FaultInjector` is installed through the seams ``CNNServer``
exposes with its ``faults=`` parameter, never by patching the server, and
is deterministic: poison targets are registered by content digest and
kills fire on a dispatch count, so a chaos run replays exactly.

Seams (called by the dispatcher thread):

- ``on_tick(n_items)``: once per dispatcher loop with work, before any
  batching. Raising here is a dispatcher crash, not a dispatch error: the
  server fails every pending future with ``ServerCrashed``. A ``kills``
  budget bounds how often it fires, so a supervised restart can recover
  instead of looping.
- ``on_restart(restarts)``: called by the
  :class:`~repro_torch.launch.supervisor.Supervisor` once it has the
  dispatcher back up; the injector records the count.
- ``pre_bucket(bucket)``: just before a bucket's plan dispatch, never
  before its fallback. ``fail_bucket`` registers a persistent fault there
  that raises until ``heal_bucket``, the shape of a broken kernel path: the
  server demotes the bucket to its fallback, and a later probe promotes it
  again once healed.
- ``pre_dispatch(pendings)``: before a batch is assembled. Raising
  :class:`FaultInjected` here is a plan exception; the server runs the seam
  again on every bisected half, so a poisoned request raises all the way
  down to its lone dispatch, as a real deterministic poison input would.
- ``pre_serve(pendings, xb) -> xb``: after host assembly, before the bucket
  dispatch: a slow plan (``slow_s``).
- ``post_serve(pendings, y) -> y``: after the dispatch, before the logits
  are handed out: NaN activations in a poisoned request's rows. They are
  put there, past the datapath, because a NaN in a request's input is
  rejected at admission, and a NaN inside the int8 chain becomes code 0 at
  the next requantize (as in the reference), so only the server's output
  check can isolate a numeric fault.

:func:`bad_input` builds malformed requests (wrong shape, rank or dtype,
non-finite values) that admission (``validate_request``) rejects alone;
:func:`corrupt_checkpoint` writes deterministic damage into a checkpoint on
disk, so the store's verification meets real corruption.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import time
from typing import List, Optional

import numpy as np


class FaultInjected(RuntimeError):
    """The typed error every injector raises: chaos tests assert that
    exactly the poisoned future carries it."""


def bad_input(kind: str, sample_shape, *, dtype=np.float32, n: int = 1,
              seed: int = 0) -> np.ndarray:
    """A deterministic malformed request: ``'shape'`` (the last dim one too
    long), ``'rank'`` (a dim missing), ``'dtype'`` (float64 for float32),
    ``'nan'`` / ``'inf'`` (the right shape, one non-finite value)."""
    rng = np.random.default_rng(seed)
    shape = (n,) + tuple(sample_shape)
    if kind == "shape":
        return rng.standard_normal(shape[:-1] + (shape[-1] + 1,)).astype(dtype)
    if kind == "rank":
        return rng.standard_normal(shape[:-1]).astype(dtype)
    if kind == "dtype":
        return rng.standard_normal(shape).astype(
            np.float64 if np.dtype(dtype) != np.float64 else np.float32)
    if kind in ("nan", "inf"):
        x = rng.standard_normal(shape).astype(dtype)
        x[tuple(0 for _ in shape)] = np.nan if kind == "nan" else np.inf
        return x
    raise ValueError(f"unknown bad_input kind {kind!r}")


def corrupt_checkpoint(ckpt_dir, *, step: Optional[int] = None, mode: str = "flip",
                       seed: int = 0) -> pathlib.Path:
    """Deterministic damage to a checkpoint on disk (the latest step unless
    ``step``); returns the step's directory. ``mode``: ``'flip'`` one seeded
    byte of ``arrays.npz`` past the zip header, ``'truncate'`` the archive
    to half its length, ``'manifest'`` a manifest field edited without
    re-digesting, ``'missing'`` the archive deleted. Each must raise
    ``CorruptCheckpointError`` at restore."""
    from repro_torch.checkpoint.store import latest_step

    ckpt_dir = pathlib.Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    arrays = d / "arrays.npz"
    if mode == "flip":
        raw = bytearray(arrays.read_bytes())
        i = 64 + np.random.default_rng(seed).integers(max(len(raw) - 128, 1))
        raw[int(i)] ^= 0xFF
        arrays.write_bytes(bytes(raw))
    elif mode == "truncate":
        raw = arrays.read_bytes()
        arrays.write_bytes(raw[: len(raw) // 2])
    elif mode == "manifest":
        mf = d / "manifest.json"
        manifest = json.loads(mf.read_text())
        manifest["n_leaves"] = int(manifest.get("n_leaves", 0)) + 1
        mf.write_text(json.dumps(manifest))  # the digest left stale on purpose
    elif mode == "missing":
        arrays.unlink()
    else:
        raise ValueError(f"unknown corrupt_checkpoint mode {mode!r}")
    return d


def _digest(x) -> str:
    a = np.ascontiguousarray(np.asarray(x))
    h = hashlib.sha1()
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())
    return h.hexdigest()


class FaultInjector:
    """Deterministic hook bundle for ``CNNServer(faults=...)``.

    ``slow_s``: a sleep in every ``pre_serve`` (a uniformly slow plan).
    ``kill_after_dispatches``: once this many dispatches have run, the next
    dispatcher tick with work raises (a dispatcher kill); None disables.
    ``kills``: how many kills fire in all (None: no bound); ``kills=1`` is
    a transient crash a supervised restart recovers from, no bound a crash
    loop the circuit breaker must stop.
    """

    def __init__(self, *, slow_s: float = 0.0, kill_after_dispatches: Optional[int] = None,
                 kills: Optional[int] = None):
        self.slow_s = float(slow_s)
        self.kill_after_dispatches = kill_after_dispatches
        self.kills = kills
        self.kills_fired = 0          # dispatcher kills delivered
        self.restarts = 0             # supervisor restarts seen
        self.dispatches = 0           # pre_serve calls seen
        self.faults_fired = 0         # poison, kill and bucket raises delivered
        self.bucket_faults_fired = 0  # pre_bucket raises delivered
        self._poison = {}             # content digest -> 'raise' | 'nan'
        self._bad_buckets = {}        # bucket -> raises left (None: until healed)

    def poison(self, x, mode: str = "raise"):
        """Register ``x`` (one request's array) as poison and return it.
        ``'raise'``: a batch holding it fails at ``pre_dispatch``; ``'nan'``:
        its logits rows become NaN at ``post_serve``."""
        if mode not in ("raise", "nan"):
            raise ValueError(f"mode must be 'raise' or 'nan', got {mode!r}")
        self._poison[_digest(x)] = mode
        return x

    def is_poisoned(self, x, mode: str = "raise") -> bool:
        return self._poison.get(_digest(x)) == mode

    def fail_bucket(self, bucket: int, *, times: Optional[int] = None) -> None:
        """A persistent fault on one bucket's plan: every ``pre_bucket(bucket)``
        raises, ``times`` times (None: until :meth:`heal_bucket`). The
        fallback never passes this seam."""
        self._bad_buckets[int(bucket)] = times

    def heal_bucket(self, bucket: int) -> None:
        """Clear a bucket's fault: the server's next probe of the plan
        succeeds and promotes the bucket again."""
        self._bad_buckets.pop(int(bucket), None)

    def on_tick(self, n_items: int) -> None:
        if (self.kill_after_dispatches is not None
                and self.dispatches >= self.kill_after_dispatches and n_items > 0
                and (self.kills is None or self.kills_fired < self.kills)):
            self.faults_fired += 1
            self.kills_fired += 1
            raise FaultInjected(f"dispatcher killed after {self.dispatches} dispatches")

    def on_restart(self, restarts: int) -> None:
        self.restarts = int(restarts)

    def pre_bucket(self, bucket: int) -> None:
        left = self._bad_buckets.get(int(bucket), 0)
        if left is None or left > 0:
            if left is not None:
                if left > 1:
                    self._bad_buckets[int(bucket)] = left - 1
                else:
                    self._bad_buckets.pop(int(bucket), None)
            self.faults_fired += 1
            self.bucket_faults_fired += 1
            raise FaultInjected(f"backend fault on bucket-{bucket}'s plan dispatch")

    def pre_dispatch(self, pendings: List) -> None:
        hit = [p for p in pendings if self.is_poisoned(p.x, "raise")]
        if hit:
            self.faults_fired += 1
            raise FaultInjected(f"plan exception: {len(hit)} poisoned request(s) in a "
                                f"batch of {len(pendings)}")

    def pre_serve(self, pendings: List, xb: np.ndarray) -> np.ndarray:
        self.dispatches += 1
        if self.slow_s > 0:
            time.sleep(self.slow_s)
        return xb

    def post_serve(self, pendings: List, y: np.ndarray) -> np.ndarray:
        off = 0
        for p in pendings:
            if self.is_poisoned(p.x, "nan"):
                self.faults_fired += 1
                y = np.array(y)  # a copy: never write into a shared output
                y[off: off + p.n] = np.nan
            off += p.n
        return y
