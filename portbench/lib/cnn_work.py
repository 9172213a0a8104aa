"""The work of a ResNet configuration's layers at a batch, from their shapes
alone, as ``work.py`` counts the LM's: operations (a multiply and an add
count two; a compressed layer counts the ``nnz / bz`` of the dense MACs it
keeps) and bytes (each input read once and each output written once, in the
precision the chain holds them: int8 codes between layers, float32 images
into the stem and float32 out of the last block; each layer's weights, its
kept positions and its float32 rows of scales, bias and requantize scales
once). Nothing here depends on how the program splits or fuses its kernels.
"""
from __future__ import annotations

from portbench.lib.cnn_weights import cnn_layout, head_features

# One H100 SXM's float32 rate on the CUDA cores (no tensor cores), the
# stem's precision: NVIDIA's data sheet, 67 TFLOP/s at 700 W
FP32_OPS_PER_S = 67e12


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def conv_work(cfg: dict, batch: int) -> list:
    """Every conv at ``batch`` images, in the layout's order: name, ``kind``
    ('stem', 'conv3x3' or 'conv1x1'), ``ops``, ``bytes``. A block's last
    conv reads its shortcut's int8 codes too; the last block's writes
    float32."""
    d = cfg["dbb"]
    layout = cnn_layout(cfg)
    last_c3 = max(i for i, c in enumerate(layout) if c["name"].endswith(".c3"))
    out = []
    for i, c in enumerate(layout):
        role = c["name"].rsplit(".", 1)[-1]
        if role == "stem":
            h_in = cfg["image_size"]
        elif role == "c1":
            block_in = h_in = cur
        elif role == "proj":
            h_in = block_in
        else:  # c2, c3: the conv before's output
            h_in = prev
        ho = _out(h_in, c["k"], c["stride"], c["pad"])
        if role == "stem":
            k, s, p = cfg["max_pool"]
            cur = _out(ho, k, s, p)
        elif role != "proj":
            prev = ho
            if role == "c3":
                cur = ho
        m = batch * ho * ho
        kk = c["k"] * c["k"] * c["cin"]
        f = c["cout"]
        if c["dense"]:
            ops = 2 * m * kk * f
            nbytes = 4 * batch * h_in * h_in * c["cin"] + 4 * kk * f + m * f + 3 * 4 * f
            kind = "stem"
        else:
            kc = kk // d["bz"] * d["nnz"]
            ops = 2 * m * kc * f
            width = 4 if i == last_c3 else 1
            # a strided 1 x 1 conv reads only the pixels it lands on
            h_read = ho if c["k"] == 1 else h_in
            nbytes = batch * h_read * h_read * c["cin"] + kc * f + kc + width * m * f + 3 * 4 * f
            if c["name"].endswith(".c3"):
                nbytes += m * f + 4  # the shortcut's codes and their scale
            kind = "conv1x1" if c["k"] == 1 else "conv3x3"
        out.append({"name": c["name"], "kind": kind, "ops": ops, "bytes": nbytes})
    return out


def maxpool_bytes(cfg: dict, batch: int) -> int:
    """The max-pool's int8 codes in (the stem's output) and out."""
    size, c = cfg["image_size"], cfg["stem_channels"]
    h = _out(size, cfg["stem_kernel"], cfg["stem_stride"], cfg["stem_padding"])
    k, s, p = cfg["max_pool"]
    ho = _out(h, k, s, p)
    return batch * c * (h * h + ho * ho)


def head_work(cfg: dict, batch: int) -> dict:
    """The head: the pooled features quantized to codes, the compressed FC,
    float32 logits."""
    d = cfg["dbb"]
    f, n = head_features(cfg), cfg["num_classes"]
    kc = f // d["bz"] * d["nnz"]
    return {"ops": 2 * batch * kc * n, "bytes": batch * f + kc * n + kc + 4 * batch * n + 8 * n}


def int8_ops(cfg: dict, batch: int) -> float:
    """Every int8 operation of one request: the compressed convs and the head."""
    return (sum(w["ops"] for w in conv_work(cfg, batch) if w["kind"] != "stem")
            + head_work(cfg, batch)["ops"])


def stem_ops(cfg: dict, batch: int) -> float:
    return sum(w["ops"] for w in conv_work(cfg, batch) if w["kind"] == "stem")
