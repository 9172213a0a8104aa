"""The work a layer needs, from its shapes alone: operations (a multiply and
an add count two; a compressed product counts the ``nnz / bz`` of the dense
MACs it keeps) and bytes (each input byte counted once as read, each output
byte once as written, in the precision the configuration states). Nothing
here depends on how the program splits or fuses its kernels.
"""
from __future__ import annotations

from portbench.lib.weights import lm_layout, padded_vocab


def _kc(k: int, cfg: dict) -> int:
    d = cfg["dbb"]
    return k // d["bz"] * d["nnz"]


def _index_bytes(k: int, cfg: dict) -> int:
    """One int8 position per kept row of the shared ('matrix') pattern."""
    return _kc(k, cfg)


def lm_projection_work(cfg: dict, m: int, precision: str) -> list:
    """Every compressed projection of the model at ``m`` rows, one entry per
    layer and projection: ``bf16`` reads bf16 activations and values,
    ``int8`` int8 codes and values plus a float32 scale row; both write bf16
    and read the shared pattern's positions."""
    width = 2 if precision == "bf16" else 1  # bytes of an activation and of a value
    out = []
    for layer in range(cfg["num_layers"]):
        for name, (k, n) in lm_layout(cfg).items():
            kc = _kc(k, cfg)
            nbytes = (m * k + kc * n) * width + _index_bytes(k, cfg) + 2 * m * n
            if precision == "int8":
                nbytes += 4 * n
            out.append({"name": f"{layer}.{name}", "ops": 2 * m * kc * n, "bytes": nbytes})
    return out


def lm_attention_ops(cfg: dict, batch: int, queries: int, keys_per_query) -> float:
    """Score and value products of every layer: 2 · 2 · heads · head_dim per
    (query, key) pair; ``keys_per_query`` is the mean number of keys a query
    attends (causal: what the mask keeps)."""
    per_pair = 4 * cfg["num_heads"] * cfg["head_dim"]
    return cfg["num_layers"] * per_pair * batch * queries * keys_per_query


def lm_head_ops(cfg: dict, rows: int) -> float:
    return 2 * rows * cfg["d_model"] * padded_vocab(cfg)


def kv_bytes_per_token(cfg: dict) -> int:
    """K and V of one position over every layer, bf16."""
    return cfg["num_layers"] * 2 * cfg["num_kv_heads"] * cfg["head_dim"] * 2


def decode_mean_keys(traffic: dict) -> float:
    """The mean positions a decode step attends: step i (i = 0 … gen_len - 2)
    attends prompt_len + i + 1."""
    return traffic["prompt_len"] + 1 + (traffic["gen_len"] - 2) / 2


def lm_decode_step_bytes(cfg: dict, batch: int, mean_keys: float) -> float:
    """The bytes a decode step must move: every compressed projection's
    values and positions, the q/k/v biases and the LayerNorms, the batch's
    embedding rows, the dense head whole, the cache's K/V at the positions
    each query attends (``mean_keys`` on average) read and one position
    written; activations are counted at bf16 in and out of each
    projection."""
    d = cfg["d_model"]
    proj = sum(w["bytes"] for w in lm_projection_work(cfg, batch, "bf16"))
    layout = lm_layout(cfg)
    biases = 2 * (layout["wq"][1] + layout["wk"][1] + layout["wv"][1])
    norms = 2 * 2 * 2 * d
    per_layer = biases + norms
    head = 2 * d * padded_vocab(cfg) + 2 * 2 * d + 2 * batch * d
    cache = kv_bytes_per_token(cfg) * batch * (mean_keys + 1)
    return proj + cfg["num_layers"] * per_layer + head + cache
