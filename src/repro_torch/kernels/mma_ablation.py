"""Where the time of the int8 tensor-core core (``csrc/os_mma.cuh``) goes:
the bw conv at three ``sparse-cnn-s`` layer shapes (batch 64) and the bw
head, each built from a scratch copy of ``csrc/`` with parts of the stage
switched off, timed by torch.profiler's device time.

    PYTHONPATH=src python -m repro_torch.kernels.mma_ablation

Needs a CUDA card and nvcc. Variants: ``as built``; ``no B loads`` (the B
stager's fetch replaced by a constant); ``no A copies`` (no cp.async);
``no mma`` (the mma replaced by an integer add); and their combinations.
The outputs of the switched variants are meaningless; only their times
count. The copies are built under ``build/kernels/ablation/``.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import I, P

# anchor in os_mma.cuh -> its replacement under each switch
SWITCHES = {
    "NO_A": ("      cp_async<CH>(smem_u32(&As[s][a_row + i * ROW_STEP][a_col]), src, ok);\n", ""),
    "NO_B": ("      raw[i] = stage_b.fetch(kt * BK + (b_grp + i * COL_STEP) * 8, n0 + b_col, K);\n",
             "      raw[i] = RawB{0x01010101u + kt, 0x01010101u, 0x76543210u};\n"),
    "NO_MMA": ("          mma_s8(acc[i][j], af[i], bf[j / 2][(j % 2) * 2], bf[j / 2][(j % 2) * 2 + 1]);\n",
               "          acc[i][j][0] += af[i][0] ^ bf[j / 2][0];\n"),
}
VARIANTS = {"as built": (), "no B loads": ("NO_B",), "no A copies": ("NO_A",),
            "no mma": ("NO_MMA",), "no A, no B": ("NO_A", "NO_B"),
            "no A, no B, no mma": ("NO_A", "NO_B", "NO_MMA")}
# (images, H, W, C, F) of l1, l3 and l7 at batch 64; 3x3 taps, stride 1
CONVS = {"l1": (64, 64, 64, 64, 64), "l3": (64, 32, 32, 128, 128), "l7": (64, 8, 8, 512, 512)}
HEAD = (64, 512, 1000)  # (M, K, N)
NNZ = 3


def variant_sources(name: str, switches, csrc: Path = build.CSRC) -> Path:
    """A copy of ``csrc`` (the sources as committed) with ``switches``
    applied to os_mma.cuh."""
    out = build.build_dir() / "ablation" / name.replace(" ", "_").replace(",", "")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    core = out / "os_mma.cuh"
    text = core.read_text()
    for sw in switches:
        anchor, replacement = SWITCHES[sw]
        if text.count(anchor) != 1:
            raise RuntimeError(f"{sw}: its anchor is not in os_mma.cuh once")
        text = text.replace(anchor, replacement)
    core.write_text(text)
    return out


def device_ms(fn, reps: int = 5, tries: int = 3):
    """Mean device time of one call of ``fn`` (all its CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.end - ev.time_range.start for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
        if us:
            return sum(us) / reps / 1e3
    return None


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_ablation: no CUDA card available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    def weight(k, f):
        nb = k // 8
        pos = torch.argsort(torch.rand(nb, 8, f, generator=gen), dim=1)[:, :NNZ]
        return codes(nb, NNZ, f), pos.sort(dim=1).values.to(torch.int8).to(dev)

    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = []
    for n, h, w, c, f in CONVS.values():
        x, (v, idx) = codes(n, h, w, c), weight(9 * c, f)
        out = torch.empty(n * h * w * f, dtype=torch.int32, device=dev)
        args = (x.data_ptr(), v.data_ptr(), idx.data_ptr(), None, None, None, 0, out.data_ptr(),
                0, 0, n, h, w, c, f, h, w, 3, 3, 1, 1, 1, 1, 8, NNZ, 1, stream)
        cases.append(("vdbb_conv_bw", args, (x, v, idx, out)))
    m, k, n = HEAD
    a, (v, idx) = codes(m, k), weight(k, n)
    out = torch.empty(m * n, dtype=torch.int32, device=dev)
    cases.append(("vdbb_matmul_bw", (a.data_ptr(), v.data_ptr(), idx.data_ptr(), None, None,
                                     None, 0, out.data_ptr(), 0, 0, m, k, n, 8, NNZ, 1, stream),
                  (a, v, idx, out)))

    argtypes = {"vdbb_conv_bw": [P, P, P, P, P, P, I, P, I, I] + [I] * 16 + [P],
                "vdbb_matmul_bw": [P, P, P, P, P, P, I, P, I, I, I, I, I, I, I, I, P]}
    sources = {"vdbb_conv_bw": "vdbb_conv_bw.cu", "vdbb_matmul_bw": "vdbb_matmul_bw.cu"}
    print(f"{'variant':<20s} " + " ".join(f"{name:>9s}" for name in [*CONVS, "head"])
          + "   (device ms, raw int32 out)")
    csrc, registry = build.CSRC, dict(build.KERNELS)
    try:
        for name, switches in VARIANTS.items():
            build.CSRC = variant_sources(name, switches, csrc)
            kernels = {kn: build.CudaKernel(kn, sources[kn], argtypes[kn], replaces="ablation")
                       for kn in sources}
            build.build_all(tuple(sources.values()))
            row = [device_ms(lambda kn=kn, args=args: kernels[kn].launch(*args))
                   for kn, args, _ in cases]
            print(f"{name:<20s} " + " ".join(f"{t:9.4f}" if t is not None else f"{'none':>9s}"
                                             for t in row), flush=True)
    finally:
        build.CSRC = csrc
        build.KERNELS.clear()
        build.KERNELS.update(registry)
    return 0


if __name__ == "__main__":
    sys.exit(main())
