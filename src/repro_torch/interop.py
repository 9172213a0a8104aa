"""Parameters from the JAX reference, as numpy arrays, into the port's state.

A parameter tree is nested dicts of numpy arrays: the CNN's ``{"l{i}":
{"w", "b", "aq"}}`` or the LM's (``embed``, ``layers`` stacked over layer
groups, ``tail``, ``final_norm``, ``lm_head`` and the ``<leaf>_aq``
siblings). A compressed weight arrives as a dict ``{values, indices[,
scales], bz, nnz, group, shape}`` (``scales`` makes it a
:class:`QuantDBBWeight`), stacked or not (a leading layers axis on
``values``, ``indices`` and ``scales``); ``group`` is None, ``'matrix'`` or
an int, or the strings ``'none'`` / ``'<int>'`` as an ``.npz`` file stores
them. numpy has no bf16, so a bf16 array travels as its raw bits: a dict
``{"bf16": uint16 array}`` (:func:`bf16_bits`), read back bit for bit. A
leaf of seeded noise may travel as its recipe instead, ``{"seed", "shape",
"std"}`` for bf16 (:func:`seeded_bf16`) or ``{"seed", "shape", "std",
"fp32"}`` for fp32 (:func:`seeded_fp32`): drawn again, the same bits on
both sides (a fixture keeps a MoE's expert stacks so, and the audio
model's codebook tables and head, not their values).

``flatten`` / ``unflatten`` map a tree to and from the ``'/'``-joined keys of
an ``.npz`` archive. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import QuantDBBWeight
from repro_torch.core.vdbb import DBBFormat, DBBWeight


def _group(v):
    if v is None:
        return None
    v = np.asarray(v).item() if not isinstance(v, (str, int)) else v
    if isinstance(v, str):
        if v.lower() == "none":
            return None
        return v if v == "matrix" else int(v)
    return int(v)


def bf16_bits(bits) -> dict:
    """A bf16 array as this module carries it: its raw bits as uint16."""
    return {"bf16": np.asarray(bits).view(np.uint16)}


SEEDED = {"seed", "shape", "std"}
SEEDED_FP32 = SEEDED | {"fp32"}


def seeded_fp32(seed, shape, std, fp32=True) -> np.ndarray:
    """Normal noise of ``std`` from numpy's ``default_rng(seed)``, in fp32.
    (``fp32`` is the recipe's tag, :data:`SEEDED_FP32`.)"""
    shape = tuple(int(s) for s in np.asarray(shape).reshape(-1))
    x = np.random.default_rng(int(np.asarray(seed))).standard_normal(shape, dtype=np.float32)
    return x * np.float32(np.asarray(std))


def seeded_bf16(seed, shape, std) -> dict:
    """:func:`seeded_fp32`'s noise rounded to bf16 (to nearest, ties to
    even) in numpy, as :func:`bf16_bits` carries it."""
    bits = seeded_fp32(seed, shape, std).view(np.uint32)
    return bf16_bits(((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16))


def _tensor(v, device):
    if isinstance(v, dict) and set(v) == SEEDED_FP32:
        v = seeded_fp32(**v)
    if isinstance(v, dict) and set(v) == SEEDED:
        v = seeded_bf16(**v)
    if isinstance(v, dict) and set(v) == {"bf16"}:
        bits = np.ascontiguousarray(np.asarray(v["bf16"]).view(np.int16))
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(v)).to(device)


def _leaf(v, device):
    if isinstance(v, dict) and "values" in v:
        fmt = DBBFormat(int(np.asarray(v["bz"])), int(np.asarray(v["nnz"])), _group(v.get("group")))
        shape = tuple(int(s) for s in np.asarray(v["shape"]).reshape(-1))
        values = _tensor(v["values"], device)
        indices = torch.from_numpy(np.array(v["indices"], np.int8)).to(device)
        if "scales" in v:
            scales = torch.from_numpy(np.array(v["scales"], np.float32)).to(device)
            return QuantDBBWeight(values, indices, scales, fmt, shape)
        return DBBWeight(values, indices, fmt, shape)
    if isinstance(v, dict) and set(v) not in ({"bf16"}, SEEDED, SEEDED_FP32):
        return {k: _leaf(x, device) for k, x in v.items()}
    return _tensor(v, device)


def params_from_numpy(tree: dict, device) -> dict:
    """The port's state (``SparseCNN.load_state``'s or ``LM.load_params``'s
    argument) on ``device``."""
    return {k: _leaf(v, torch.device(device)) for k, v in tree.items()}


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> ``{'a/b/c': array}``; ``group`` is stored as a string."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        elif k == "group":
            out[key] = np.asarray("none" if v is None else str(v))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat) -> dict:
    """``{'a/b/c': array}`` (or an opened ``.npz``) -> nested dicts."""
    tree: dict = {}
    for key in flat.keys():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(flat[key])
    return tree
