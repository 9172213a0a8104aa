"""The program under test, built from the benchmark's configuration files and
weights: ``repro_torch``'s own models, set up through their normal life cycle
(load the weights, compress, calibrate, quantize, plan). This is the only
module of the harness besides the loops that imports the program."""
from __future__ import annotations

import dataclasses

import torch

from portbench.lib import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _fmt(cfg: dict):
    from repro_torch.core.vdbb import DBBFormat

    d = cfg["dbb"]
    return DBBFormat(d["bz"], d["nnz"], d["pattern"])


def lm_config(cfg: dict):
    from repro_torch.models.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields and k not in ("dbb",)}
    for k in ("param_dtype", "compute_dtype"):
        kw[k] = DTYPES[kw[k]]
    return ModelConfig(dbb=_fmt(cfg), **kw)


def build_lm(cfg: dict, seed: int, device):
    """An ``LM`` holding the benchmark's weights (the layers stacked as the
    program's tree keeps them), every projection compressed."""
    from repro_torch.models.model import LM

    n = cfg["num_layers"]
    stacked = {}
    for layer in range(n):
        for k, v in weights.lm_layer(cfg, seed, layer, device).items():
            if k not in stacked:
                stacked[k] = torch.empty((n,) + tuple(v.shape), dtype=v.dtype, device=device)
            stacked[k][layer].copy_(v)
    outer = weights.lm_outer(cfg, seed, device)
    s = stacked
    block = {"norm1": {"g": s.pop("norm1_g"), "b": s.pop("norm1_b")},
             "norm2": {"g": s.pop("norm2_g"), "b": s.pop("norm2_b")},
             "mlp": {"w_up": s.pop("w_up"), "w_down": s.pop("w_down")},
             "mixer": s}
    tree = {"embed": outer["embed"], "layers": {"b0": block},
            "final_norm": {"g": outer["final_g"], "b": outer["final_b"]},
            "lm_head": outer["lm_head"]}
    return LM(lm_config(cfg)).load_params(tree).compress()
