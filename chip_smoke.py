#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run:
  1. the card's name and power limit (nvidia-smi) and the kernels' build;
  2. every kernel against its plain PyTorch version on the card, at every
     layer shape of sparse-cnn-s at batch 64, int8 and fp32 instantiations,
     with random nonzero biases: int8 and int32 exact, fp32 within
     rtol = atol = 1e-5, the stem's requantized codes within one code on at
     most 0.1 % of entries (fp32 summation order);
  3. sparse-cnn-s end to end through ``repro_torch.launch.serve``: request
     batches of 1, 8 and 64, one stem, seven conv and one head launch per
     forward, each batch's logits against the plain chain on the same card
     and images (equal when the stem codes agree, else within 1e-3
     relative L2); then a
     torch.profiler pass over served forwards at batch 1 and 64 (device
     time per kernel, the card's idle share);
  4. the committed golden fixture of the JAX reference
     (tests/data/torch_parity_cnn.npz) through ``interop.params_from_numpy``;
  5. one JSON line of the kernels (launches, errors, times, bounds).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the repository's ``src/repro_torch`` beside this file, it exits
nonzero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
FIXTURE = ROOT / "tests" / "data" / "torch_parity_cnn.npz"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
BATCH = 64
REQUESTS = 8
REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int = 5):
    """Mean device time of the port's kernels in one call of ``fn``, from
    torch.profiler's CUDA activity (None where it records none). Unlike
    :func:`cuda_ms` it leaves out the host's share of each call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.end - ev.time_range.start for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA
          and kernel_family(ev.name) != "other"]
    return sum(us) / reps / 1e3 if us else None


def bound(nbytes: int, ops: int, ops_per_s: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_codes(got, want, what: str) -> int:
    """Requantized codes from an fp32 accumulator: within one code, on at
    most 0.1 % of entries. Returns the largest difference."""
    d = (got.int() - want.int()).abs()
    dmax, frac = int(d.max()), float((d > 0).float().mean())
    if dmax > 1 or frac > 1e-3:
        raise AssertionError(f"{what}: codes differ by up to {dmax} on {frac:.2%} of entries")
    return dmax


def check_exact(got, want, what: str) -> float:
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        d = (got.double() - want.double()).abs().max() if got.shape == want.shape else "shape"
        raise AssertionError(f"{what}: not equal to the plain version (max diff {d})")
    return 0.0


def check_close(got, want, what: str) -> float:
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{what}: max |diff| {float((got - want).abs().max())} "
                             "beyond rtol = atol = 1e-5")
    return float((got - want).abs().max())


# ---------------------------------------------------------------- phase 2


def layer_shapes(cfg, batch):
    """(layer, input shape) for every layer of the model at ``batch``."""
    from repro_torch.core.sparse_conv import DBBConv2d
    from repro_torch.models.cnn import SparseCNN

    h = cfg.image_size
    out = []
    for m in SparseCNN(cfg).layers():
        if isinstance(m, DBBConv2d):
            out.append((m, (batch, h, h, m.in_channels)))
            h = m.out_hw(h, h)[0]
        else:
            out.append((m, (batch, m.in_features)))
    return out


def check_kernels(cfg, gen, dev):
    """Phase 2. Returns per-kernel records for the JSON line."""
    from repro_torch.core.quant import quantize_dbb
    from repro_torch.core.vdbb import dbb_decode, dbb_encode, dbb_encode_conv
    from repro_torch.kernels import im2col_conv as stem_k
    from repro_torch.kernels import vdbb_im2col_conv as conv_k
    from repro_torch.kernels import vdbb_matmul as head_k

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    def dequant_scales(n, kc):
        # int8 codes (std ~73) times int8 weights (std ~40) over kc terms,
        # scaled so the requantized output codes spread over about ±40
        return ((torch.rand(n, generator=gen) + 1.0) / (2900.0 * kc ** 0.5)).to(dev)

    recs = {"im2col_conv": [], "vdbb_conv_tc": [], "vdbb_matmul_tc": []}
    layers = layer_shapes(cfg, BATCH)
    n_conv = sum(1 for m, _ in layers[:-1])
    log(f"[kernels] layer  kernel          shape                   ms       device_ms  "
        f"plain_ms  library_ms  bound_ms (by)")
    for li, (m, xshape) in enumerate(layers):
        last = li == len(layers) - 1
        f = m.out_features if last else m.out_channels
        bias = rnd(f, scale=0.5)
        out_scale = 0.05 if li + 1 < n_conv else None  # layer 7 flushes fp32 into GAP
        if li == 0:
            # stem: fp32 in, int8 codes out (the main path) ...
            x, w = rnd(*xshape), rnd(m.kh, m.kw, m.in_channels, f, scale=0.2)
            kw = dict(bias=bias, relu=True, out_scale=out_scale, stride=m.stride,
                      padding=m.padding)
            run = lambda: stem_k.im2col_conv(x, w, **kw)  # noqa: E731
            plain = lambda: stem_k.im2col_conv_plain(x, w, **kw)  # noqa: E731
            err = check_codes(run(), plain(), "stem fp32->int8")
            # ... fp32 out, and the int8 instantiation
            kw32 = dict(bias=bias, relu=True, stride=m.stride, padding=m.padding)
            check_close(stem_k.im2col_conv(x, w, **kw32),
                        stem_k.im2col_conv_plain(x, w, **kw32), "stem fp32")
            xq, wq = codes(*xshape), codes(m.kh, m.kw, m.in_channels, f)
            ki = dict(stride=m.stride, padding=m.padding)
            check_exact(stem_k.im2col_conv(xq, wq, **ki),
                        stem_k.im2col_conv_plain(xq, wq, **ki), "stem int8")
            xn = x.permute(0, 3, 1, 2).contiguous()
            wn = w.permute(3, 2, 0, 1).contiguous()
            library = lambda: F.conv2d(xn, wn, bias, stride=m.stride, padding=1)  # noqa: E731
            out = run()
            nb_ = nbytes(x, w, bias, out)
            ops = 2 * out.numel() * m.kh * m.kw * m.in_channels
            b_ms, b_by = bound(nb_, ops, FP32_OPS_PER_S)
            name = "im2col_conv"
        elif not last:
            wt = rnd(m.kh, m.kw, m.in_channels, f, scale=(9 * m.in_channels) ** -0.5)
            qw = quantize_dbb(dbb_encode_conv(wt, m.fmt, prune=True))
            idx = qw.indices[:, :, 0].contiguous()
            xq = codes(*xshape)
            scales = dequant_scales(f, idx.numel())
            kw = dict(scales=scales, bias=bias, relu=True, out_scale=out_scale,
                      stride=m.stride, padding=m.padding)
            args = (xq, qw.values, idx, m.fmt, m.kh, m.kw)
            run = lambda: conv_k.vdbb_im2col_conv_tc(*args, **kw)  # noqa: E731
            plain = lambda: conv_k.vdbb_im2col_conv_tc_plain(*args, **kw)  # noqa: E731
            err = check_exact(run(), plain(), f"conv l{li} int8")
            ki = dict(stride=m.stride, padding=m.padding)
            check_exact(conv_k.vdbb_im2col_conv_tc(*args, **ki),
                        conv_k.vdbb_im2col_conv_tc_plain(*args, **ki), f"conv l{li} int32")
            dw = dbb_encode_conv(wt, m.fmt, prune=True)
            x32 = rnd(*xshape)
            a32 = (x32, dw.values, dw.indices[:, :, 0].contiguous(), m.fmt, m.kh, m.kw)
            k32 = dict(bias=bias, relu=True, stride=m.stride, padding=m.padding)
            check_close(conv_k.vdbb_im2col_conv_tc(*a32, **k32),
                        conv_k.vdbb_im2col_conv_tc_plain(*a32, **k32), f"conv l{li} fp32")
            xn = x32.permute(0, 3, 1, 2).contiguous()
            wn = dbb_decode(dw).reshape(m.kh, m.kw, m.in_channels, f).permute(3, 2, 0, 1).contiguous()
            library = lambda: F.conv2d(xn, wn, bias, stride=m.stride, padding=1)  # noqa: E731
            out = run()
            nb_ = nbytes(xq, qw.values, idx, scales, bias, out)
            ops = 2 * out.numel() * qw.values.shape[0] * qw.values.shape[1]
            b_ms, b_by = bound(nb_, ops, INT8_OPS_PER_S)
            name = "vdbb_conv_tc"
        else:
            wt = rnd(m.in_features, f, scale=m.in_features ** -0.5)
            dw = dbb_encode(wt, m.fmt, prune=True)
            qw = quantize_dbb(dw)
            idx = qw.indices[:, :, 0].contiguous()
            aq = codes(*xshape)
            scales = dequant_scales(f, idx.numel())
            kw = dict(scales=scales, bias=bias)
            args = (aq, qw.values, idx, m.fmt)
            run = lambda: head_k.vdbb_matmul_tc(*args, **kw)  # noqa: E731
            plain = lambda: head_k.vdbb_matmul_tc_plain(*args, **kw)  # noqa: E731
            err = check_exact(run(), plain(), "head int8->fp32")
            check_exact(head_k.vdbb_matmul_tc(*args), head_k.vdbb_matmul_tc_plain(*args),
                        "head int32")
            a32 = (rnd(*xshape), dw.values, dw.indices[:, :, 0].contiguous(), m.fmt)
            check_close(head_k.vdbb_matmul_tc(*a32, bias=bias),
                        head_k.vdbb_matmul_tc_plain(*a32, bias=bias), "head fp32")
            wdense = dbb_decode(qw.as_dbb()).contiguous()
            library = lambda: torch._int_mm(aq, wdense)  # noqa: E731
            out = run()
            nb_ = nbytes(aq, qw.values, idx, scales, bias, out)
            ops = 2 * out.numel() * qw.values.shape[0] * qw.values.shape[1]
            b_ms, b_by = bound(nb_, ops, INT8_OPS_PER_S)
            name = "vdbb_matmul_tc"
        ms, plain_ms, lib_ms = cuda_ms(run), cuda_ms(plain), cuda_ms(library)
        dev_ms = kernel_device_ms(run)
        recs[name].append(dict(err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bytes=nb_,
                               ops=ops))
        log(f"[kernels] l{li:<5d} {name:<15s} {str(tuple(xshape)):<23s} {ms:<8.4f} "
            f"{dev_ms if dev_ms is None else round(dev_ms, 4)!s:<10s} {plain_ms:<9.4f} "
            f"{lib_ms:<11.4f} {b_ms:.5f} ({b_by})")
    return recs


# ---------------------------------------------------------------- phase 3


def plain_chain(model, x):
    """The int8-resident chain through the kernels' plain versions, on the
    same card: the yardstick of the served logits."""
    from repro_torch.core.quant import QuantDBBWeight, resolve_quant_input
    from repro_torch.kernels import im2col_conv as stem_k
    from repro_torch.kernels import vdbb_im2col_conv as conv_k
    from repro_torch.kernels import vdbb_matmul as head_k

    layers = model.layers()
    convs, head = layers[:-1], layers[-1]
    stem_out = None
    for i, m in enumerate(convs):
        out_scale = convs[i + 1].aq if i + 1 < len(convs) else None
        conv = dict(bias=m.b, relu=True, out_scale=out_scale, stride=m.stride,
                    padding=m.padding)
        if isinstance(m.w, QuantDBBWeight):
            x = conv_k.vdbb_im2col_conv_tc_plain(
                x, m.w.values, m.w.indices[:, :, 0].contiguous(), m.w.fmt, m.kh, m.kw,
                scales=m.aq * m.w.scales, **conv)
        else:
            x = stem_k.im2col_conv_plain(x, m.w, **conv)
            stem_out = x
    xq, s_a = resolve_quant_input(x.mean(dim=(1, 2)), head.aq)
    logits = head_k.vdbb_matmul_tc_plain(xq, head.w.values, head.w.indices[:, :, 0].contiguous(),
                                         head.w.fmt, scales=s_a * head.w.scales, bias=head.b)
    return logits, stem_out


def end_to_end(dev):
    """Phase 3: serve sparse-cnn-s through ``launch.serve``; returns (the
    launches of that run, images/s per request batch)."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    build.reset_launches()
    model, x, served = serve.serve("sparse-cnn-s", batches=(1, 8, BATCH),
                                   requests=REQUESTS, device=dev, seed=0, log=log)
    main_counts = build.launch_counts()
    want = {"im2col_conv": 1, "vdbb_conv_tc": 7, "vdbb_matmul_tc": 1}
    for b, r in served.items():
        if r["launches_per_forward"] != want:
            raise AssertionError(f"batch {b}: launches per forward "
                                 f"{r['launches_per_forward']}, want {want}")
        logits = r["logits"]
        if logits.shape != (b, 1000) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"batch {b}: logits {tuple(logits.shape)} not finite (b, 1000)")
        # the served logits of each request batch against the plain chain on
        # the same images; a rerun with intermediates gives the stem codes
        xb = x[:b].contiguous()
        with torch.no_grad():
            inter = []
            check_exact(model(xb, intermediates=inter), logits, f"batch {b}: rerun logits")
            ref, ref_stem = plain_chain(model, xb)
        check_codes(inter[0], ref_stem, f"batch {b}: served stem codes")
        if torch.equal(inter[0], ref_stem):
            check_exact(logits, ref, f"batch {b}: served logits")
            log(f"[serve] batch {b}: logits equal the plain chain's on the card")
        else:
            err = rel_l2(logits, ref)
            if err > 1e-3:
                raise AssertionError(f"batch {b}: served logits rel L2 {err} > 1e-3 "
                                     "vs the plain chain")
            log(f"[serve] batch {b}: logits within rel L2 {err:.3e} of the plain chain's")
    return main_counts, {b: r["images_per_s"] for b, r in served.items()}, model, x


# ------------------------------------------------------------ where the time goes

KERNEL_OF_LOADER = {"GatherTap": "vdbb_conv_tc", "GatherCols": "vdbb_matmul_tc",
                    "Tap": "im2col_conv"}


def kernel_family(name: str) -> str:
    """The port's kernel a CUDA kernel name belongs to (they share one
    template, told apart by the operand loader), else 'other'."""
    if "os_gemm" in name:
        for loader, kernel in KERNEL_OF_LOADER.items():
            if f"{loader}<" in name:
                return kernel
    return "other"


def profile_forwards(model, x, reps: int = 4) -> dict:
    """Device time per kernel and the device's idle share over ``reps``
    served forwards, from torch.profiler's CUDA activity. Idle is the share
    of the host-clock window in which no kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    spans, per = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        fam = kernel_family(ev.name)
        per[fam] = per.get(fam, 0.0) + (b - a) / reps / 1e3
    if not spans:
        return {"device_ms": None, "wall_ms": wall_us / reps / 1e3, "idle": None, "per_kernel_ms": {}}
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"device_ms": busy / reps / 1e3, "wall_ms": wall_us / reps / 1e3,
            "idle": max(0.0, 1.0 - busy / wall_us), "per_kernel_ms": per}


# ---------------------------------------------------------------- phase 4


def golden(dev):
    """Phase 4: the JAX reference's fixture through the port on the card."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import smoke_cnn_config
    from repro_torch.interop import params_from_numpy, unflatten
    from repro_torch.models.cnn import SparseCNN

    with np.load(FIXTURE) as z:
        tree = unflatten(z)
    cfg = dataclasses.replace(smoke_cnn_config("sparse-cnn-tiny"), convs_per_stage=2)
    model = SparseCNN(cfg).load_state(params_from_numpy(tree["params"], dev))
    x = torch.as_tensor(tree["input"]).to(dev)
    want_inter = [torch.as_tensor(tree["intermediates"][str(i)]).to(dev)
                  for i in range(len(tree["intermediates"]))]
    with torch.no_grad():
        inter = []
        logits = model(x, intermediates=inter)
        check_codes(inter[0], want_inter[0], "fixture stem codes")
        convs = model.layers()[:-1]
        for i in range(1, len(convs)):
            out_scale = convs[i + 1].aq if i + 1 < len(convs) else None
            got = convs[i].quant_serve(want_inter[i - 1], relu=True, out_scale=out_scale)
            check_exact(got, want_inter[i], f"fixture layer l{i}")
        head = model.layers()[-1].quant_serve(torch.as_tensor(tree["pooled"]).to(dev))
        check_exact(head, torch.as_tensor(tree["logits"]).to(dev), "fixture head")
    err = rel_l2(logits, torch.as_tensor(tree["logits"]).to(dev))
    if err > 1e-3:
        raise AssertionError(f"fixture logits: rel L2 {err} > 1e-3 vs JAX")
    log(f"[golden] JAX fixture: layers exact, logits within rel L2 {err:.3e}")


# ------------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build, ops  # noqa: F401  (registers the kernels)

    # full fp32 for the library calls timed beside the kernels (F.conv2d)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda", 0)
    build.build_all()
    log(f"[build] {len(build.SOURCES)} sources in {time.time() - t0:.1f} s -> {build.build_dir()}")
    for src in build.SOURCES:
        for line in build.library_path(src).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    from repro_torch.configs import get_cnn_config

    cfg = get_cnn_config("sparse-cnn-s")
    gen = torch.Generator().manual_seed(1)
    recs = check_kernels(cfg, gen, dev)
    log(f"[kernels] every kernel matches its plain version ({time.time() - t0:.1f} s)")

    counts, ips, model, x = end_to_end(dev)
    log(f"[serve] main-path launches (calibration, warm-ups and {REQUESTS} requests at each "
        f"batch): {counts} ({time.time() - t0:.1f} s)")
    for b in (1, BATCH):
        p = profile_forwards(model, x[:b].contiguous())
        log(f"[profile] batch {b}: per forward {json.dumps(p)}")

    golden(dev)

    line = []
    library_call = {"im2col_conv": "F.conv2d fp32 (TF32 off)",
                    "vdbb_conv_tc": "F.conv2d fp32 on decoded weights (TF32 off)",
                    "vdbb_matmul_tc": "torch._int_mm on the decoded int8 weight"}
    for name, rs in recs.items():
        k = build.KERNELS[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces, "launches": counts[name],
            "max_abs_err": max(r["err"] for r in rs),
            "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
            "device_ms": (None if any(r["device_ms"] is None for r in rs)
                          else sum(r["device_ms"] for r in rs)),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": sum(r["library_ms"] for r in rs),
            "library_call": library_call[name], "layers": len(rs),
        })
    log(f"[serve] images/s per request batch: {json.dumps(ips)}")
    log(f"[done] {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
