"""Helpers for the tests that hold ``repro_torch`` against ``repro``.

Only tests import both packages: this module turns the JAX package's
parameters into numpy trees (the form ``repro_torch.interop`` reads) and
builds the golden fixtures from the JAX reference in ref mode:
``tests/data/torch_parity_cnn.npz`` (one pattern shared across each layer's
outputs, the tc kernels) and ``tests/data/torch_parity_cnn_bw.npz``
(per-column patterns, the bw kernels). Regenerate both with

    PYTHONPATH=src python tests/torch_parity.py
"""
from __future__ import annotations

import dataclasses
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro.configs.cnn import smoke_cnn_config  # noqa: E402
from repro.core.quant import QuantDBBWeight  # noqa: E402
from repro.core.vdbb import DBBWeight  # noqa: E402
from repro.models.cnn import SparseCNN  # noqa: E402
from repro_torch.interop import flatten  # noqa: E402

FIXTURE = ROOT / "tests" / "data" / "torch_parity_cnn.npz"
FIXTURE_BW = ROOT / "tests" / "data" / "torch_parity_cnn_bw.npz"
CHAIN_BATCH = 8
CHAIN_SEED = 0
# the fixture holds batch 4 (under 200 KB); its head runs at M = 4, below
# the TPU reference's 8-row tiny-M fallback, which the port does not have
FIXTURE_BATCH = 4


def to_numpy(tree):
    """A JAX parameter tree as numpy: compressed weights become dicts of
    ``values, indices[, scales], bz, nnz, group, shape``."""
    if isinstance(tree, (DBBWeight, QuantDBBWeight)):
        out = dict(values=np.array(tree.values), indices=np.array(tree.indices),
                   bz=tree.fmt.bz, nnz=tree.fmt.nnz, group=tree.fmt.group,
                   shape=np.array(tree.shape))
        if isinstance(tree, QuantDBBWeight):
            out["scales"] = np.array(tree.scales)
        return out
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


def from_numpy(tree):
    """The inverse of :func:`to_numpy`: a numpy tree (as ``interop.unflatten``
    gives it) as the JAX package's parameter tree."""
    from repro.core.vdbb import DBBFormat

    if isinstance(tree, dict) and "values" in tree:
        group = str(np.asarray(tree["group"]))
        fmt = DBBFormat(int(np.asarray(tree["bz"])), int(np.asarray(tree["nnz"])),
                        None if group == "none" else group if group == "matrix" else int(group))
        shape = tuple(int(s) for s in np.asarray(tree["shape"]).reshape(-1))
        values, indices = jnp.asarray(tree["values"]), jnp.asarray(tree["indices"])
        if "scales" in tree:
            return QuantDBBWeight(values, indices, jnp.asarray(tree["scales"]), fmt, shape)
        return DBBWeight(values, indices, fmt, shape)
    if isinstance(tree, dict):
        return {k: from_numpy(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def chain_config(pattern="matrix"):
    """The chain test's model: sparse-cnn-tiny's smoke config with two convs
    per stage (an int8 -> int8 conv, a stride-2 conv, a head at M = batch);
    ``pattern=None`` gives every output column its own pattern."""
    return dataclasses.replace(smoke_cnn_config("sparse-cnn-tiny", pattern=pattern),
                               convs_per_stage=2)


def random_biases(params: dict, rng: np.random.Generator) -> dict:
    return {k: dict(p, b=jnp.array(rng.normal(0.0, 0.1, p["b"].shape), jnp.float32))
            for k, p in params.items()}


def jax_chain(seed: int = CHAIN_SEED, batch: int = CHAIN_BATCH, pattern="matrix") -> dict:
    """The JAX reference's int8-resident chain in ref mode: input, quantized
    params (numpy), every conv's output, the pooled vector and the logits."""
    cfg = chain_config(pattern)
    model = SparseCNN(cfg)
    rng = np.random.default_rng(seed)
    params = random_biases(model.init(jax.random.PRNGKey(seed)), rng)
    params = model.compress(params)
    x = rng.normal(size=(batch, cfg.image_size, cfg.image_size, cfg.in_channels)).astype(np.float32)
    _, stats = model.apply(params, jnp.array(x), collect_act_stats=True)
    qparams = model.quantize(params, stats)
    inter = []
    logits = model.apply(qparams, jnp.array(x), intermediates=inter)
    return dict(input=x, params=to_numpy(qparams),
                intermediates={str(i): np.array(t) for i, t in enumerate(inter)},
                pooled=np.array(inter[-1].mean(axis=(1, 2))), logits=np.array(logits))


def fixture_bytes(chain: dict) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **flatten(chain))
    return buf.getvalue()


if __name__ == "__main__":
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    for path, pattern in ((FIXTURE, "matrix"), (FIXTURE_BW, None)):
        path.write_bytes(fixture_bytes(jax_chain(batch=FIXTURE_BATCH, pattern=pattern)))
        print(f"wrote {path} ({path.stat().st_size} bytes)")
