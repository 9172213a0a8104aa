"""Atomic, async, verified checkpoints (port of ``repro/checkpoint/store.py``).

The on-disk format is the reference's, so a checkpoint either package wrote
restores into the other:

- ``<dir>/step_{n:08d}/arrays.npz`` holds the leaves as ``a0, a1, …`` and
  ``manifest.json`` their count (``n_leaves``), dtype names (``dtypes``), a
  sha256 per leaf over the bytes written (``digests``) and a digest of the
  manifest itself (``manifest_sha256``).
- A save writes into a temporary directory beside the step's, fsyncs it and
  renames it into place, so a crash mid-write never damages the latest
  checkpoint.
- Leaves are numbered in JAX's flatten order, and the store never parses
  the manifest's ``treedef`` string: :func:`restore` flattens the caller's
  template in that order. Dict keys come sorted (``"l10"`` before
  ``"l2"``), a :class:`~repro_torch.core.vdbb.DBBWeight` gives (values,
  indices) and a :class:`~repro_torch.core.quant.QuantDBBWeight` (values,
  indices, scales), as their pytree registrations do in the reference;
  ``None`` gives no leaf. Format and shape come from the template.
- Dtypes an ``.npz`` cannot hold travel as same-width unsigned bits: bf16
  as uint16, the fp8 formats as uint8. The port reads them back through a
  same-width integer view into ``torch.bfloat16`` / ``torch.float8_*``
  (no ``ml_dtypes``). int4 and uint4 have no torch dtype and raise
  :class:`UnsupportedDtypeError`; they are never decoded silently.
- Every restore re-hashes what it reads and raises
  :class:`CorruptCheckpointError` on any mismatch, truncation or missing
  file; ``restore(..., fallback=True)`` walks back to the newest step that
  still verifies (the serving tier's reload path).

``restore`` takes ``device=`` where the reference takes ``shardings=``:
resharding onto a mesh waits for the port's distribution (ROADMAP item 14).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import re
import shutil
import tempfile
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import QuantDBBWeight
from repro_torch.core.vdbb import DBBWeight


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed verification at restore: a leaf or manifest
    digest mismatched, a file is missing or truncated, or the archive is
    unreadable. Typed so that the serving tier keeps the old weights
    serving instead of loading garbage."""


class UnsupportedDtypeError(TypeError):
    """A checkpoint leaf's dtype has no torch counterpart (int4, uint4)."""


# dtypes an .npz cannot hold, stored as same-width unsigned bits
_BITCAST = {
    "bfloat16": np.uint16,
    "float8_e4m3fn": np.uint8,
    "float8_e5m2": np.uint8,
    "int4": np.uint8,
    "uint4": np.uint8,
}
# how the port reads the bits back: a same-width integer view into the dtype
_TORCH_BITS = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
_TORCH_INT = {np.uint16: torch.int16, np.uint8: torch.uint8}


# ------------------------------------------------------------- tree order

def _children(node) -> Optional[Tuple[list, list]]:
    """``(children, keys)`` of an inner node in JAX's flatten order, or None
    for a leaf. ``None`` is an inner node without children."""
    if node is None:
        return [], []
    if isinstance(node, dict):
        keys = sorted(node)
        return [node[k] for k in keys], [f"[{k!r}]" for k in keys]
    if isinstance(node, (list, tuple)):
        return list(node), [f"[{i}]" for i in range(len(node))]
    if isinstance(node, QuantDBBWeight):
        return [node.values, node.indices, node.scales], [".values", ".indices", ".scales"]
    if isinstance(node, DBBWeight):
        return [node.values, node.indices], [".values", ".indices"]
    return None


def flatten(tree, path: str = "") -> Tuple[list, list]:
    """``(leaves, paths)`` of ``tree`` in JAX's flatten order; a path reads
    like the reference's ``keystr`` (``['l1']['w'].values``)."""
    kids = _children(tree)
    if kids is None:
        return [tree], [path]
    leaves, paths = [], []
    for child, key in zip(*kids):
        lv, ps = flatten(child, path + key)
        leaves += lv
        paths += ps
    return leaves, paths


def unflatten(tree_like, leaves: list):
    """``tree_like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if node is None:
            return None
        new = [build(c) for c in kids[0]]
        if isinstance(node, dict):
            return dict(zip(sorted(node), new))
        if isinstance(node, (list, tuple)):
            return type(node)(new)
        names = ("values", "indices", "scales")[:len(new)]
        return dataclasses.replace(node, **dict(zip(names, new)))

    return build(tree_like)


# ------------------------------------------------------------ bytes on disk

def _host(x) -> Tuple[np.ndarray, str]:
    """A leaf as the array written (bits for a dtype an .npz cannot hold)
    and its dtype name; a tensor on the card is copied to the host here."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if name in _BITCAST:
            bits = _BITCAST[name]
            return t.view(_TORCH_INT[bits]).numpy().view(bits), name
        return t.numpy(), name
    a = np.asarray(x)
    name = str(a.dtype)
    return (a.view(_BITCAST[name]) if name in _BITCAST else a), name


def _decode(a: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    """A leaf as read back into a tensor on the host."""
    if dtype in _TORCH_BITS:
        view, torch_dtype = _TORCH_BITS[dtype]
        return torch.from_numpy(np.ascontiguousarray(a).view(view).copy()).view(torch_dtype)
    if dtype in _BITCAST:
        raise UnsupportedDtypeError(f"checkpoint leaf of dtype {dtype}: torch has no such "
                                    "dtype, and its bits are not decoded silently")
    return torch.from_numpy(np.array(a))


def _sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _manifest_digest(manifest: dict) -> str:
    """Digest of the manifest's content, its own digest field excluded."""
    body = {k: v for k, v in manifest.items() if k != "manifest_sha256"}
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()


def _snapshot(tree) -> Tuple[List[np.ndarray], List[str], str]:
    """The leaves as written, their dtype names, and the leaves' paths as
    the manifest's ``treedef`` (a record for readers; nothing parses it)."""
    leaves, paths = flatten(tree)
    host, dtypes = [], []
    for x in leaves:
        a, name = _host(x)
        host.append(a)
        dtypes.append(name)
    return host, dtypes, " ".join(paths)


def _write(ckpt_dir: pathlib.Path, step: int, host, dtypes, treedef: str,
           extra: Optional[dict]) -> pathlib.Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"tmp.{step}.", dir=ckpt_dir))
    try:
        np.savez(tmp / "arrays.npz", **{f"a{i}": a for i, a in enumerate(host)})
        manifest = {
            "step": step,
            "treedef": treedef,
            "n_leaves": len(host),
            "dtypes": dtypes,
            "digests": [_sha256(a) for a in host],  # over the bytes written
            "extra": extra or {},
        }
        manifest["manifest_sha256"] = _manifest_digest(manifest)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        for f in tmp.iterdir():  # durable before the rename makes it visible
            fd = os.open(f, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def save(ckpt_dir, step: int, tree, *, extra: Optional[dict] = None) -> pathlib.Path:
    """Synchronous atomic save of ``tree`` (dicts, lists, tensors on any
    device, numpy arrays, compressed weights). Returns the step's path."""
    host, dtypes, treedef = _snapshot(tree)
    return _write(pathlib.Path(ckpt_dir), step, host, dtypes, treedef, extra)


class AsyncCheckpointer:
    """Copy to the host synchronously; write in a background thread, keeping
    the newest ``keep`` steps."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save_async(self, step: int, tree, *, extra=None) -> None:
        self.wait()
        host, dtypes, treedef = _snapshot(tree)  # the device->host copy happens here

        def work():
            _write(self.ckpt_dir, step, host, dtypes, treedef, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in list_steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s:08d}", ignore_errors=True)


def list_steps(ckpt_dir) -> list:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_verified(ckpt_dir, *, step: Optional[int] = None):
    """Read and verify one checkpoint; no template needed.

    Returns ``(manifest, raw_leaves)``, the leaves as written (bits for a
    dtype an .npz cannot hold). Raises :class:`CorruptCheckpointError` on a
    missing or unreadable file, a manifest whose own digest mismatches, a
    wrong leaf count, or a leaf whose sha256 differs from the one recorded
    at save. A checkpoint without digests verifies its structure only.
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except (OSError, ValueError) as e:
        raise CorruptCheckpointError(f"step {step}: manifest.json unreadable: {e}") from e
    recorded = manifest.get("manifest_sha256")
    if recorded is not None and recorded != _manifest_digest(manifest):
        raise CorruptCheckpointError(f"step {step}: manifest digest mismatch (manifest "
                                     "edited or truncated after save)")
    n = manifest.get("n_leaves")
    if not isinstance(n, int) or n < 0:
        raise CorruptCheckpointError(f"step {step}: manifest has no usable n_leaves ({n!r})")
    try:
        with np.load(d / "arrays.npz") as data:
            # every leaf read inside the try: an npz reads lazily, so a
            # truncated archive may fail only at a member's access
            raw = [np.asarray(data[f"a{i}"]) for i in range(n)]
    except Exception as e:  # noqa: BLE001 -- missing, truncated or unreadable
        raise CorruptCheckpointError(
            f"step {step}: arrays.npz unreadable ({type(e).__name__}: {e})") from e
    digests = manifest.get("digests")
    if digests is not None:
        if len(digests) != len(raw):
            raise CorruptCheckpointError(f"step {step}: {len(digests)} digests for "
                                         f"{len(raw)} leaves")
        for i, (a, want) in enumerate(zip(raw, digests)):
            if _sha256(a) != want:
                raise CorruptCheckpointError(f"step {step}: leaf {i} sha256 mismatch: the "
                                             "bytes differ from what save() recorded")
    return manifest, raw


def restore(ckpt_dir, tree_like, *, step: Optional[int] = None, device=None,
            fallback: bool = False) -> Tuple[Any, dict]:
    """Restore into the structure of ``tree_like``; returns ``(tree,
    manifest)``.

    Each leaf becomes a tensor of its template leaf's dtype on ``device``
    (by default where the template leaf lies, the host for a non-tensor).
    Every read is verified (:func:`read_verified`). ``fallback=True`` walks
    back from the requested step to the newest one that still verifies;
    the manifest's ``step`` says which loaded. A leaf count other than the
    template's raises ``AssertionError``, a leaf shape other than its
    template leaf's ``ValueError`` with the leaf's path and the step.
    Resharding onto a mesh (the reference's ``shardings=``) waits for
    ROADMAP item 14.
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    if not fallback:
        manifest, raw = read_verified(ckpt_dir, step=step)
    else:
        candidates = [s for s in reversed(list_steps(ckpt_dir)) if s <= step]
        first_err: Optional[CorruptCheckpointError] = None
        manifest = raw = None
        for s in candidates:
            try:
                manifest, raw = read_verified(ckpt_dir, step=s)
                break
            except CorruptCheckpointError as e:
                first_err = first_err or e
        if manifest is None:
            raise CorruptCheckpointError(f"no verifiable checkpoint under {ckpt_dir} (tried "
                                         f"{candidates}); first failure: {first_err}")
    step = manifest["step"]
    like, paths = flatten(tree_like)
    if manifest["n_leaves"] != len(like):
        raise AssertionError(f"checkpoint/model structure mismatch: step {step} holds "
                             f"{manifest['n_leaves']} leaves, the template {len(like)}")
    dtypes = manifest.get("dtypes") or [None] * len(like)
    out = []
    for i, (a, ref) in enumerate(zip(raw, like)):
        t = _decode(a, dtypes[i])
        if hasattr(ref, "shape") and tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i} ({paths[i]}) at step {step}: ckpt {tuple(t.shape)} "
                             f"vs model {tuple(ref.shape)}")
        dev = device if device is not None else getattr(ref, "device", "cpu")
        dtype = ref.dtype if isinstance(ref, torch.Tensor) else None
        out.append(t.to(device=torch.device(dev), dtype=dtype))
    return unflatten(tree_like, out), manifest
