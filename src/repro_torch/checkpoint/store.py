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

- Leaves that are DTensors (a model sharded over a mesh) are written as
  their logical (global) arrays, so the format stays the reference's
  whatever the mesh. Only global rank 0 (the writer) builds them: every
  other rank sends it each distinct shard it holds, one at a time, and
  rank 0 copies each into its place in a host array, so no card ever holds
  a whole leaf and no other rank copies anything to its host.
  ``restore(..., shardings=)`` lays each leaf out on a mesh (a tree of
  :class:`Sharding`): the elastic reshard on load, onto a mesh of any
  shape. Each rank reads the archive a leaf at a time, cuts its own shard
  on the host and moves only that to its card. ``device=`` stays for the
  unsharded case.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
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


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where :func:`restore` lays a leaf: ``mesh`` (a ``DeviceMesh``) and
    ``spec``, a partition spec (a tuple of mesh axis names, tuples of them
    or None per dim, ``models/common.py:spec_placements``). A leaf of its
    own in a tree, where a bare tuple would be an inner node."""

    mesh: Any
    spec: tuple


def _box(shape, mesh_shape, placements, coord) -> tuple:
    """The slices of a leaf of ``shape`` that the rank at mesh coordinate
    ``coord`` holds under ``placements``: each mesh dim either replicates
    or splits one tensor dim evenly, and mesh dims that split the same
    tensor dim nest in mesh order, as DTensor's do."""
    lo, size = [0] * len(shape), list(shape)
    for n, c, p in zip(mesh_shape, coord, placements):
        if p.is_shard():
            d = p.dim % len(shape)
            if size[d] % n:
                raise ValueError(f"dim {d} of a leaf of shape {tuple(shape)} does not split "
                                 f"evenly {n} ways")
            size[d] //= n
            lo[d] += c * size[d]
        elif not p.is_replicate():
            raise ValueError(f"a checkpoint leaf placed {p} is neither split nor replicated")
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def is_writer() -> bool:
    """True on the rank that writes a sharded checkpoint: global rank 0, or
    the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


# ------------------------------------------------------------ bytes on disk

def full_tensor(x):
    """A DTensor's logical (global) tensor, gathered on every rank (a
    collective: every rank calls it); anything else as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _gather(x) -> Optional[torch.Tensor]:
    """DTensor ``x``'s logical tensor on the writer's host, None on every
    other rank. Each distinct shard (the first of its replicas in mesh
    order) reaches the writer by a send of its own, into a buffer of one
    shard on the writer's device, and is copied into its box of the host
    tensor. Every rank of the mesh calls it."""
    import torch.distributed as dist

    ranks, pl = x.device_mesh.mesh, tuple(x.placements)
    local = x.to_local().detach().contiguous()
    writer, me = is_writer(), dist.get_rank()
    out = torch.empty(x.shape, dtype=local.dtype) if writer else None
    for coord in itertools.product(*map(range, ranks.shape)):
        if any(c and not p.is_shard() for c, p in zip(coord, pl)):
            continue  # a replica of a shard sent from another coordinate
        box = _box(x.shape, ranks.shape, pl, coord)
        src = int(ranks[coord])
        if writer and src == me:
            out[box] = local.cpu()
        elif writer:
            buf = torch.empty(out[box].shape, dtype=local.dtype, device=local.device)
            dist.recv(buf, src=src)
            out[box] = buf.cpu()
        elif src == me:
            dist.send(local, dst=0)
    return out


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
    the manifest's ``treedef`` (a record for readers; nothing parses it).
    For a tree holding DTensors every rank calls it and only the writer
    gets the leaves (:func:`_gather`); the others get empty lists."""
    from torch.distributed.tensor import DTensor

    leaves, paths = flatten(tree)
    builds = is_writer() or not _sharded(tree)
    host, dtypes = [], []
    for x in leaves:
        if isinstance(x, DTensor):
            x = _gather(x)
        if builds:
            a, name = _host(x)
            host.append(a)
            dtypes.append(name)
    return host, dtypes, " ".join(paths)


def _sharded(tree) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(x, DTensor) for x in flatten(tree)[0])


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
    device, numpy arrays, compressed weights, DTensors). Returns the step's
    path. A tree holding DTensors is saved by every rank of the world
    together: the shards go to rank 0, which writes, and all wait for the
    write."""
    sharded = _sharded(tree)
    host, dtypes, treedef = _snapshot(tree)
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not sharded:
        return _write(ckpt_dir, step, host, dtypes, treedef, extra)
    import torch.distributed as dist

    if is_writer():
        _write(ckpt_dir, step, host, dtypes, treedef, extra)
    dist.barrier()
    return ckpt_dir / f"step_{step:08d}"


class AsyncCheckpointer:
    """Copy to the host synchronously; write in a background thread, keeping
    the newest ``keep`` steps."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._sharded = False

    def save_async(self, step: int, tree, *, extra=None) -> None:
        """Snapshot now, write on a thread (on rank 0 alone when ``tree``
        holds DTensors: every rank takes the snapshot, a collective, and
        :meth:`wait` is one too)."""
        self.wait()
        self._sharded = _sharded(tree)
        host, dtypes, treedef = _snapshot(tree)  # the device->host copy happens here
        if not is_writer():
            return

        def work():
            _write(self.ckpt_dir, step, host, dtypes, treedef, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """The last write done; after a sharded save, on every rank."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            import torch.distributed as dist

            dist.barrier()
            self._sharded = False

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


def _manifest(ckpt_dir: pathlib.Path, step: int) -> dict:
    """Step ``step``'s manifest, its own digest and leaf count verified."""
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
    digests = manifest.get("digests")
    if digests is not None and len(digests) != n:
        raise CorruptCheckpointError(f"step {step}: {len(digests)} digests for {n} leaves")
    return manifest


def _verified_leaves(ckpt_dir: pathlib.Path, step: int, manifest: dict):
    """Step ``step``'s leaves as written, read one at a time, each checked
    against its recorded sha256 as it is read."""
    digests = manifest.get("digests")

    def unreadable(e):
        return CorruptCheckpointError(
            f"step {step}: arrays.npz unreadable ({type(e).__name__}: {e})")

    try:
        data = np.load(ckpt_dir / f"step_{step:08d}" / "arrays.npz")
    except Exception as e:  # noqa: BLE001 -- missing or unreadable
        raise unreadable(e) from e
    with data:
        for i in range(manifest["n_leaves"]):
            try:  # an npz reads lazily: a truncated archive may fail only here
                a = np.asarray(data[f"a{i}"])
            except Exception as e:  # noqa: BLE001 -- truncated or unreadable
                raise unreadable(e) from e
            if digests is not None and _sha256(a) != digests[i]:
                raise CorruptCheckpointError(f"step {step}: leaf {i} sha256 mismatch: the "
                                             "bytes differ from what save() recorded")
            yield a


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
    manifest = _manifest(ckpt_dir, step)
    return manifest, list(_verified_leaves(ckpt_dir, step, manifest))


def _place(t: torch.Tensor, sh: Sharding, dtype) -> torch.Tensor:
    """Logical leaf ``t`` (on the host) as a DTensor on ``sh.mesh``: this
    rank's shard is cut on the host and only it moves to the device."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.common import spec_placements

    mesh = sh.mesh
    pl = spec_placements(sh.spec, mesh, t.shape)
    box = _box(t.shape, mesh.mesh.shape, pl, mesh.get_coordinate())
    local = t[box].to(device=torch.device(mesh.device_type), dtype=dtype, copy=True)
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False, shape=t.shape,
                              stride=t.stride())


def _restore_step(ckpt_dir: pathlib.Path, step: int, tree_like, device, shardings):
    """:func:`restore` of one step, leaf by leaf as the archive is read."""
    manifest = _manifest(ckpt_dir, step)
    raw = _verified_leaves(ckpt_dir, step, manifest)
    step = manifest["step"]
    like, paths = flatten(tree_like)
    if manifest["n_leaves"] != len(like):
        raise AssertionError(f"checkpoint/model structure mismatch: step {step} holds "
                             f"{manifest['n_leaves']} leaves, the template {len(like)}")
    dtypes = manifest.get("dtypes") or [None] * len(like)
    flat_sh = flatten(shardings)[0] if shardings is not None else [None] * len(like)
    if len(flat_sh) != len(like):
        raise ValueError(f"{len(flat_sh)} shardings for {len(like)} leaves")
    out = []
    for i, (a, ref, sh) in enumerate(zip(raw, like, flat_sh)):
        t = _decode(a, dtypes[i])
        del a
        if hasattr(ref, "shape") and tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i} ({paths[i]}) at step {step}: ckpt {tuple(t.shape)} "
                             f"vs model {tuple(ref.shape)}")
        dtype = ref.dtype if isinstance(ref, torch.Tensor) else None
        if sh is not None:
            out.append(_place(t, sh, dtype))
            continue
        dev = device if device is not None else getattr(ref, "device", "cpu")
        out.append(t.to(device=torch.device(dev), dtype=dtype))
    return unflatten(tree_like, out), manifest


def restore(ckpt_dir, tree_like, *, step: Optional[int] = None, device=None,
            shardings=None, fallback: bool = False) -> Tuple[Any, dict]:
    """Restore into the structure of ``tree_like``; returns ``(tree,
    manifest)``.

    Each leaf becomes a tensor of its template leaf's dtype on ``device``
    (by default where the template leaf lies, the host for a non-tensor).
    ``shardings`` (a tree of :class:`Sharding`, in ``tree_like``'s
    structure) lays each leaf out on its mesh instead: every rank reads the
    archive a leaf at a time and moves only its own shard to its device,
    so a checkpoint saved on one mesh restores onto a mesh of any other
    shape (the elastic reshard). Every leaf is verified as it is read
    (:func:`read_verified`'s checks). ``fallback=True`` walks back from the
    requested step to the newest one that still verifies; the manifest's
    ``step`` says which loaded. A leaf count other than the template's
    raises ``AssertionError``, a leaf shape other than its template leaf's
    ``ValueError`` with the leaf's path and the step.
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    if not fallback:
        return _restore_step(ckpt_dir, step, tree_like, device, shardings)
    candidates = [s for s in reversed(list_steps(ckpt_dir)) if s <= step]
    first_err: Optional[CorruptCheckpointError] = None
    for s in candidates:
        try:
            return _restore_step(ckpt_dir, s, tree_like, device, shardings)
        except CorruptCheckpointError as e:
            first_err = first_err or e
    raise CorruptCheckpointError(f"no verifiable checkpoint under {ckpt_dir} (tried "
                                 f"{candidates}); first failure: {first_err}")
