"""INT8 sparse-CNN serving on the card (port of the unplanned path of
``repro/launch/serve.py:serve_cnn``).

Seeded init -> compress -> calibrate (an fp32 pass through the fp32
instantiation of the same kernels) -> quantize -> serve request batches on
the int8-resident chain: one stem kernel, one IM2COL × VDBB kernel per
compressed conv, global average pooling, one head GEMM kernel.

  python -m repro_torch.launch.serve --arch sparse-cnn-s --batch 1 8 64 --requests 8

``serve(..., pattern=None)`` serves the paper's per-column patterns through
the bw kernels; the default ``pattern='matrix'`` shares one pattern across
each layer's outputs (the tc kernels).

Prints the logits' shape, images/s (CUDA events around ``--requests``
forwards per batch size) and the kernel launches per forward.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import CNN_ARCHS, get_cnn_config, smoke_cnn_config
from repro_torch.kernels import build
from repro_torch.models.cnn import SparseCNN


def build_model(arch: str, *, calib_batch: int, device, seed: int = 0,
                smoke: bool = False, sparsity=0.625, pattern="matrix"):
    """Seeded, compressed, calibrated and quantized model, plus the
    calibration batch. ``sparsity`` and ``pattern`` choose the DBB format
    (``configs.cnn``). Weights and inputs are drawn on the CPU from one
    ``torch.Generator`` and moved to ``device``."""
    dev = resolve_device(device)
    cfg = (smoke_cnn_config if smoke else get_cnn_config)(arch, sparsity=sparsity,
                                                          pattern=pattern)
    gen = torch.Generator().manual_seed(seed)
    model = SparseCNN(cfg).init(gen, dev).compress()
    x = torch.randn(calib_batch, cfg.image_size, cfg.image_size, cfg.in_channels,
                    generator=gen).to(dev)
    with torch.no_grad():
        _, stats = model(x, collect_act_stats=True)
    model.quantize(stats)
    return model, x


def time_requests(model, x, requests: int) -> tuple:
    """``requests`` forwards of batch ``x`` after one warm-up: (logits,
    seconds on CUDA events, launches of each kernel over the timed
    forwards). The launch counters keep running; the counts returned are
    their growth over the timed forwards."""
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize(x.device)
        before = build.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(requests):
            logits = model(x)
        end.record()
        torch.cuda.synchronize(x.device)
    counts = {k: v - before[k] for k, v in build.launch_counts().items()}
    return logits, start.elapsed_time(end) / 1e3, counts


def serve(arch: str = "sparse-cnn-s", *, batches=(64,), requests: int = 8,
          device=None, seed: int = 0, smoke: bool = False, sparsity=0.625,
          pattern="matrix", log=print) -> tuple:
    """Serve ``requests`` batches of each size in ``batches`` on the card.
    Returns ``(model, inputs, results)``: the quantized model, the seeded
    input batch (requests of batch b take its first b images) and
    ``{batch: {"logits", "images_per_s", "launches_per_forward"}}``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("serving is timed with CUDA events and runs on a card")
    model, xcal = build_model(arch, calib_batch=max(batches), device=dev, seed=seed,
                              smoke=smoke, sparsity=sparsity, pattern=pattern)
    fmt = model.cfg.fmt
    shared = "per column" if fmt.group is None else f"shared by group={fmt.group}"
    log(f"[serve] {model.cfg.name}: INT8-calibrated, nnz={fmt.nnz}/{fmt.bz}, pattern {shared}, "
        f"{model.cfg.param_count() / 1e6:.2f} M weights, on {torch.cuda.get_device_name(dev)}")
    out = {}
    for b in batches:
        logits, secs, counts = time_requests(model, xcal[:b].contiguous(), requests)
        per_fwd = {k: v / requests for k, v in counts.items()}
        ips = b * requests / secs
        log(f"[serve] batch {b}: logits {tuple(logits.shape)}, {ips:.1f} images/s "
            f"({secs / requests * 1e3:.4f} ms per request), launches per forward {per_fwd}")
        out[b] = {"logits": logits, "images_per_s": ips, "launches_per_forward": per_fwd}
    return model, xcal, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="sparse-cnn-s", choices=sorted(CNN_ARCHS))
    ap.add_argument("--batch", type=int, nargs="+", default=[64],
                    help="request batch sizes to serve")
    ap.add_argument("--requests", type=int, default=8, help="timed requests per batch size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="reduced config of the arch")
    ap.add_argument("--sparsity", type=float, default=0.625,
                    help="weight sparsity: 0.625 -> 3/8 DBB, 0 -> dense")
    args = ap.parse_args(argv)
    serve(args.arch, batches=args.batch, requests=args.requests, device=args.device,
          seed=args.seed, smoke=args.smoke, sparsity=args.sparsity)


if __name__ == "__main__":
    main()
