"""INT8 sparse-CNN serving on the card (port of ``repro/launch/serve.py``'s
CNN path).

Seeded init -> compress -> calibrate (an fp32 pass through the fp32
instantiation of the same kernels) -> quantize -> serve request batches on
the int8-resident chain: one stem kernel, one IM2COL × VDBB kernel per
compressed conv, global average pooling, one head GEMM kernel.

By default each request batch is served through a frozen plan
(``SparseCNN.plan_set``, one CUDA graph per batch size); ``--no-plan``
serves the unplanned forward, so one call can time both:

  python -m repro_torch.launch.serve --arch sparse-cnn-s --batch 1 8 64 --requests 8

Prints the logits' shape, images/s (CUDA events around ``--requests``
forwards per batch size) and the kernel launches per forward (a plan's: the
launches its graph captured). ``serve(..., pattern=None)`` serves the
paper's per-column patterns through the bw kernels; the default
``pattern='matrix'`` shares one pattern across each layer's outputs (the tc
kernels).

``--server`` runs the continuous-batching tier (``launch/server.py``)
instead: a plan set of buckets 1, 2, 4, … ``--max-batch``, the request
queue and micro-batcher, and Poisson arrivals of ``--requests``
single-image requests at ``--rate`` requests/s (by default half the
measured capacity of the largest bucket). It reports p50/p99 latency,
images/s, the aggregation shape and the captures after warmup:

  python -m repro_torch.launch.serve --arch sparse-cnn-s --server --requests 512
"""
from __future__ import annotations

import argparse
import time

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


def time_requests(fn, x, requests: int) -> tuple:
    """``requests`` calls of ``fn(x)`` after one warm-up: (logits, seconds on
    CUDA events, launches of each kernel over the timed calls). The launch
    counters keep running; the counts returned are their growth over the
    timed calls (a plan's graph replays launch without counting)."""
    with torch.no_grad():
        fn(x)
        torch.cuda.synchronize(x.device)
        before = build.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(requests):
            logits = fn(x)
        end.record()
        torch.cuda.synchronize(x.device)
    counts = {k: v - before[k] for k, v in build.launch_counts().items()}
    return logits, start.elapsed_time(end) / 1e3, counts


def serve(arch: str = "sparse-cnn-s", *, batches=(64,), requests: int = 8,
          device=None, seed: int = 0, smoke: bool = False, sparsity=0.625,
          pattern="matrix", plan: bool = True, log=print) -> tuple:
    """Serve ``requests`` batches of each size in ``batches`` on the card,
    through a plan set whose buckets are ``batches`` (``plan=False``: the
    unplanned forward). Returns ``(model, inputs, results)``: the quantized
    model, the seeded input batch (requests of batch b take its first b
    images) and ``{batch: {"logits", "images_per_s",
    "launches_per_forward"}}``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("serving is timed with CUDA events and runs on a card")
    model, xcal = build_model(arch, calib_batch=max(batches), device=dev, seed=seed,
                              smoke=smoke, sparsity=sparsity, pattern=pattern)
    fmt = model.cfg.fmt
    shared = "per column" if fmt.group is None else f"shared by group={fmt.group}"
    log(f"[serve] {model.cfg.name}: INT8-calibrated, nnz={fmt.nnz}/{fmt.bz}, pattern {shared}, "
        f"{model.cfg.param_count() / 1e6:.2f} M weights, on {torch.cuda.get_device_name(dev)}")
    plans = model.plan_set(buckets=batches) if plan else None
    if plans is not None:
        log(f"[serve] plan set: buckets {plans.buckets}, one CUDA graph each")
    out = {}
    for b in batches:
        xb = xcal[:b].contiguous()
        fn = model if plans is None else plans.plans[b].serve
        logits, secs, counts = time_requests(fn, xb, requests)
        if plans is None:
            per_fwd = {k: v / requests for k, v in counts.items()}
        else:
            per_fwd = plans.plans[b].graph_launches[(tuple(xb.shape), xb.dtype)]
        ips = b * requests / secs
        log(f"[serve] batch {b}{'' if plan else ' (unplanned)'}: logits {tuple(logits.shape)}, "
            f"{ips:.1f} images/s ({secs / requests * 1e3:.4f} ms per request), launches per "
            f"forward {per_fwd}")
        out[b] = {"logits": logits, "images_per_s": ips, "launches_per_forward": per_fwd}
    return model, xcal, out


def serve_continuous(plan_set, requests, *, rate: float, max_wait_ms: float = 5.0,
                     max_queue=None, shed: str = "reject", deadline_s=None, seed: int = 0,
                     log=print) -> dict:
    """Offer ``requests`` (numpy arrays of one or more images) to a
    :class:`~repro_torch.launch.server.CNNServer` over ``plan_set`` at
    Poisson arrivals of ``rate`` requests/s, after its warmup. Shed, expired
    and failed requests are tallied, not raised. Returns ``{"results"}``
    (logits or None per request), ``"failures"`` (a tally by error),
    ``"summary"`` (``ServerStats.summary()``, accounting checked),
    ``"retraces_after_warmup"`` and ``"health"``."""
    from repro_torch.launch.server import CNNServer, Overloaded, poisson_arrivals

    arrivals = poisson_arrivals(rate, len(requests), seed=seed)
    srv = CNNServer(plan_set, max_wait_ms=max_wait_ms, max_queue=max_queue, shed=shed)
    results, failures, futures = [], {}, []
    with srv:
        srv.warmup()
        t0 = time.monotonic()
        for x, t_arr in zip(requests, arrivals):
            lag = t_arr - (time.monotonic() - t0)
            if lag > 0:
                time.sleep(lag)
            try:
                futures.append(srv.submit(x, deadline_s=deadline_s))
            except Overloaded:
                failures["Overloaded"] = failures.get("Overloaded", 0) + 1
                futures.append(None)
        timeout_s = srv.request_timeout_s()
        for f in futures:
            try:
                results.append(None if f is None else f.result(timeout=timeout_s))
            except Exception as e:  # noqa: BLE001 -- tallied; the run goes on
                failures[type(e).__name__] = failures.get(type(e).__name__, 0) + 1
                results.append(None)
        health = srv.health()
    srv.stats.assert_accounting()
    s = srv.stats.summary()
    log(f"[serve] {s['completed']}/{s['offered']} images of {len(requests)} requests in "
        f"{s['batches']} batches {s['bucket_counts']} (padded_frac {s['padded_frac']}); "
        f"failures {failures or 'none'}")
    log(f"[serve] p50 {s['p50_us']} us, p99 {s['p99_us']} us, {s['throughput_rps']} images/s, "
        f"captures after warmup {srv.retraces_after_warmup}, health {health['status']}")
    return {"results": results, "failures": failures, "summary": s,
            "retraces_after_warmup": srv.retraces_after_warmup, "health": health}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="sparse-cnn-s", choices=sorted(CNN_ARCHS))
    ap.add_argument("--batch", type=int, nargs="+", default=[64],
                    help="request batch sizes to serve")
    ap.add_argument("--requests", type=int, default=8,
                    help="timed requests per batch size (with --server: requests offered)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="reduced config of the arch")
    ap.add_argument("--sparsity", type=float, default=0.625,
                    help="weight sparsity: 0.625 -> 3/8 DBB, 0 -> dense")
    ap.add_argument("--plan", action=argparse.BooleanOptionalAction, default=True,
                    help="serve through a frozen plan set (--no-plan: the unplanned forward)")
    ap.add_argument("--server", action="store_true",
                    help="the continuous-batching tier under Poisson arrivals")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="server: the largest bucket and aggregation cap")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="server: the longest a partial batch waits")
    ap.add_argument("--rate", type=float, default=None,
                    help="server: offered requests/s (default: half the measured capacity)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="server: admission bound in samples (default: unbounded)")
    ap.add_argument("--shed", choices=("reject", "block"), default="reject",
                    help="server: at --max-queue, reject (Overloaded) or block the submitter")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="server: per-request deadline (DeadlineExceeded past it)")
    args = ap.parse_args(argv)
    if not args.server:
        serve(args.arch, batches=args.batch, requests=args.requests, device=args.device,
              seed=args.seed, smoke=args.smoke, sparsity=args.sparsity, plan=args.plan)
        return
    from repro_torch.launch.server import auto_rate

    model, x = build_model(args.arch, calib_batch=args.max_batch, device=args.device,
                           seed=args.seed, smoke=args.smoke, sparsity=args.sparsity)
    plan_set = model.plan_set(max_batch=args.max_batch)
    print(f"[serve] plan set: buckets {plan_set.buckets}, max-wait {args.max_wait_ms} ms, "
          f"max-queue {args.max_queue} ({args.shed})")
    rate = args.rate
    if rate is None:
        rate, bucket_us = auto_rate(plan_set, x.shape[1:])
        print(f"[serve] auto rate: {rate:.1f} requests/s (half the capacity; the largest "
              f"bucket takes {bucket_us:.0f} us)")
    pool = x.cpu().numpy()
    requests = [pool[i % pool.shape[0]][None] for i in range(args.requests)]
    serve_continuous(plan_set, requests, rate=rate, max_wait_ms=args.max_wait_ms,
                     max_queue=args.max_queue, shed=args.shed,
                     deadline_s=args.deadline_ms / 1e3 if args.deadline_ms else None,
                     seed=args.seed)


if __name__ == "__main__":
    main()
