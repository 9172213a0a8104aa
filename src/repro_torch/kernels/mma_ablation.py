"""Where the time of the int8 tensor-core core (``csrc/os_mma.cuh``) goes:
the bw conv and the tc conv at three ``sparse-cnn-s`` layer shapes (batch
64), the bw head and the tc head; where the time of the stem's direct conv
(``csrc/im2col_conv.cu``) goes at ``sparse-cnn-s`` batch 64; and where the
time of the bf16 tensor-core core (``csrc/bf16_mma.cuh``) goes at the eight
``starcoder2-7b`` projection shapes (4 and 1024 rows); and where the time of
the tc matmul's staged int8 core (``csrc/os_mma_sm90.cuh``: TMA, the mux in
shared memory, wgmma) goes at the same shapes at 64 to 2 048 rows, beside
``os_mma.cuh``'s instance (mma.sync) that the rule takes below
``core.WGMMA_MIN_M``. Each kernel is built from a scratch copy of ``csrc/``
with parts switched off, and timed by torch.profiler's device time.

    PYTHONPATH=src python -m repro_torch.kernels.mma_ablation [int8] [stem] [bf16] [wgmma] [conv1x1]

(no argument: the first four tables). ``conv1x1`` times ResNet-50's 1 x 1
stride-1 convs at batch 64 (stage 1's and stage 4's, as served: bias, ReLU,
int8 codes out) on both routes a plan can stage them on, the tc conv at
kh = kw = 1 (``os_mma.cuh`` with ``TapMux``) and the tc matmul over the
(N*H*W, C) rows (the wgmma core the rule takes there), from the sources as
they are.

Needs a CUDA card and nvcc. Variants of the core: ``as built``; ``no B
loads`` (the B stager's fetch replaced by a constant); ``no A copies`` (no
cp.async, and no gather loads for the tc kernels' register-staged A); ``no
mma`` (the mma replaced by an integer add); every combination of the three;
and ``no zero test`` (the flush divides a zero dividend too, as before the
test in ``epilogue.cuh``). The convs run as served: dequantize, bias, ReLU
and requantize to int8 codes (about half of them zero); the heads return
the raw int32 accumulator. The stem's variants: ``no division`` (the
flush's IEEE division by the requantize scale replaced by a multiply), ``no
zero test``, ``no flush`` (the accumulators' raw bytes stored), ``no taps``
(the loop over the 27 taps skipped), and the first version's thread tile (4
pixels x 16 filters, 2 blocks an SM); each with ReLU (as the stem runs,
half its outputs zero) and without, and timed by CUDA events too (20
back-to-back launches). The outputs of the switched variants are
meaningless; only their times count. The bf16 core's variants: ``no B
loads`` (no cp.async of the values), ``no A loads`` (no cp.async of A's
words at decode, no 2-byte loads into registers at prefill), ``no A
stores`` (the words not compacted, the registers not stored, into the
tile the mmas read), ``no A gather`` (neither), ``no mma`` (the mma
replaced by an xor into the accumulator), ``no split reduce`` (each output
sums rank 0's partial alone: the cluster's other partials are parked but
not read), ``no prefill split`` (the large tile never splits K_c),
``decode A in registers`` (the small tile gathers A as the large one does,
no words), and ``128 x 128 prefill tile`` (the prefill instance's tile of
128 x 128 in place of 128 x 256, at the split the host's rule takes for
the 128 x 256 tile), all on bf16 outputs. The wgmma core's variants (fp32
out, as the INT8 plan flushes): ``no mux`` (the dense rows not turned into
the operand: the consumers read the buffer as it is), ``no wgmma`` (the
products replaced by an add), both, and ``no cluster`` (each CTA loads all
of A, no multicast); its copies build only the nnz = 3 instance. Every case
launches with the
rules' choices (``core.mma_plan``, ``core.bf16_mma_plan``), passed as the
kernels' arguments. The copies are built under ``build/kernels/ablation/``.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, ops  # noqa: F401  (registers the kernels)
from repro_torch.kernels.build import I, P
from repro_torch.kernels.core import bf16_mma_plan, mma_plan
from repro_torch.kernels.timing import device_ms, event_ms

# anchor in os_mma.cuh -> its replacement under each switch
SWITCHES = {
    "NO_A": ("        cp_async<CH>(smem_u32(&As[s][a_row + i * ROW_STEP][a_col]), src, ok);\n", ""),
    "NO_GATHER": ("        raw[q / 8].v[q % 8] = stage_a.fetch_byte(a_rows.row[warp + 8 * (q / 2)], src[q % 2]);\n",
                  "        raw[q / 8].v[q % 8] = 0u;\n"),
    "NO_B": ("      raw[i] = stage_b.fetch(kt * BK + (b_grp + i * COL_STEP) * 8, n0 + b_col, K);\n",
             "      raw[i] = RawB{0x01010101u + kt, 0x01010101u, 0x76543210u};\n"),
    "NO_MMA": ("          mma_s8(acc[i][j], af[i], bf[j / 2][(j % 2) * 2], bf[j / 2][(j % 2) * 2 + 1]);\n",
               "          acc[i][j][0] += af[i][0] ^ bf[j / 2][0];\n"),
}
# switches of other sources: the flush's (epilogue.cuh, every kernel's) and
# the stem's: source in csrc/, anchor, replacement
_REQUANTIZE = "      float q = y == 0.0f ? 0.0f : rintf(__fdiv_rn(y, ep.out_scale[n]));\n"
SOURCE_SWITCHES = {
    "NO_DIV": ("epilogue.cuh", _REQUANTIZE, "      float q = rintf(__fmul_rn(y, ep.out_scale[n]));\n"),
    "NO_ZERO_TEST": ("epilogue.cuh", _REQUANTIZE,
                     "      float q = rintf(__fdiv_rn(y, ep.out_scale[n]));\n"),
    "NO_FLUSH": ("im2col_conv.cu",
                 "    q[f] = static_cast<uint8_t>(epilogue_flush<float, int8_t>(acc[f], fb + f, ep));\n",
                 "    q[f] = __float_as_uint(acc[f]);\n"),
    "NO_TAPS": ("im2col_conv.cu", "  for (int dy = 0; dy < t.kh; ++dy)\n",
                "  for (int dy = 0; dy < 0; ++dy)\n"),
    # the first version's thread tile: 4 pixels x 16 filters (an 8 x 32 block
    # tile, 2 blocks an SM) in place of 4 x 8 (4 x 32, 4 blocks)
    "TH8": ("im2col_conv.cu", "constexpr int TH = 4;", "constexpr int TH = 8;"),
    "FT16": ("im2col_conv.cu", "constexpr int FT = 8;", "constexpr int FT = 16;"),
    "BLOCKS2": ("im2col_conv.cu", "constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 2;"),
}
# the bf16 core's switches (bf16_mma.cuh); the large tile's launch line
_LARGE = "  if (rows == 128) return launch_typed<128, 256, BCH, Out>(ga, args, split, stream);\n"
SOURCE_SWITCHES.update({
    "NO_B16": ("bf16_mma.cuh",
               "        cp_async<16>(smem_u32(dst), ok ? src_b : args.v, ok);\n", ""),
    "NO_GATHER16": ("bf16_mma.cuh",
                    "      cp_async<4>(smem_u32(&Aw[(slot * BM + warp + 8 * i) * BK + lane]),\n"
                    "                  ok ? p + (size_t)8 * i * ga.lda : ga.a, ok);\n", ""),
    "NO_GATHER_REG": ("bf16_mma.cuh",
                      "      ra[i] = ldg_u16_if(p + (size_t)8 * i * ga.lda, kok && warp + 8 * i < rows);\n",
                      "      ra[i] = 0u;\n"),
    "NO_STORE_A": ("bf16_mma.cuh",
                   "      dst[(warp + 8 * i) * T::AP + lane] = static_cast<uint16_t>(ra[i]);\n",
                   "      (void)dst;\n"),
    "NO_COMPACT": ("bf16_mma.cuh",
                   "      dst[(warp + 8 * i) * T::AP + lane] =\n"
                   "          static_cast<uint16_t>(Aw[(slot * BM + warp + 8 * i) * BK + lane] >> sh);\n",
                   "      (void)sh;\n"),
    "NO_MMA16": ("bf16_mma.cuh",
                 "          mma_bf16(acc[i][j], af[b][i], bf[b][j / 2][(j % 2) * 2], bf[b][j / 2][(j % 2) * 2 + 1]);\n",
                 "          acc[i][j][0] += __uint_as_float(af[b][i][0] ^ bf[b][j / 2][0]);\n"),
    "NO_REDUCE": ("bf16_mma.cuh",
                  "      if (s < split) sum.x += v[s].x, sum.y += v[s].y, sum.z += v[s].z, sum.w += v[s].w;\n",
                  "      (void)v[s];\n"),
    # no split of K_c at prefill (the large tile launched with a split of 1)
    "NO_PREFILL_SPLIT": ("bf16_mma.cuh", _LARGE, _LARGE.replace("args, split,", "args, 1,")),
    # A through registers at decode too (no words, no compaction)
    "REG_DECODE": ("bf16_mma.cuh",
                   "  static constexpr bool REG_A = !SMALL;          // A through registers, else by words\n",
                   "  static constexpr bool REG_A = true;\n"),
    # the prefill tile of 128 x 128
    "NARROW": ("bf16_mma.cuh", _LARGE, _LARGE.replace("<128, 256,", "<128, 128,")),
})
_A_LOADS, _A_STORES = ("NO_GATHER16", "NO_GATHER_REG"), ("NO_COMPACT", "NO_STORE_A")
BF16_VARIANTS = {"as built": (), "no B loads": ("NO_B16",), "no A loads": _A_LOADS,
                 "no A stores": _A_STORES, "no A gather": _A_LOADS + _A_STORES,
                 "no mma": ("NO_MMA16",), "no split reduce": ("NO_REDUCE",),
                 "no prefill split": ("NO_PREFILL_SPLIT",),
                 "decode A in registers": ("REG_DECODE",), "128 x 128 prefill tile": ("NARROW",)}
# (K, N) of starcoder2-7b's projections (chip_smoke.LM_SHAPES) and the rows
# of a decode step and of a 4 x 256 prefill
LM_SHAPES = {"wq/wo": (4608, 4608), "wk/wv": (4608, 512), "w_up": (4608, 18432),
             "w_down": (18432, 4608)}
LM_ROWS = (4, 1024)
STEM_VARIANTS = {"as built": (), "no division": ("NO_DIV",), "no zero test": ("NO_ZERO_TEST",),
                 "no flush": ("NO_FLUSH",),
                 "no taps": ("NO_TAPS",), "no taps, no flush": ("NO_TAPS", "NO_FLUSH"),
                 "4 x 16 a thread": ("TH8", "FT16", "BLOCKS2")}
STEM = (64, 64, 64, 3, 64)  # (images, H, W, C, F) of the sparse-cnn-s stem at batch 64
# the wgmma core's switches (os_mma_sm90.cuh); ONE_NNZ, in every variant,
# builds the nnz = 3 instance alone
SOURCE_SWITCHES.update({
    "ONE_NNZ": ("os_mma_sm90.cuh", "  auto fn = kernel<NNZ, GatherMuxSmem>;\n",
                "  auto fn = kernel<3, GatherMuxSmem>;\n  if (NNZ != 3) return cudaErrorInvalidValue;\n"),
    "NO_MUX": ("os_mma_sm90.cuh", "      StageA::template mux<NNZ>(",
               "      if (false) StageA::template mux<NNZ>("),
    "NO_WGMMA": ("os_mma_sm90.cuh",
                 "          wgmma_n128(acc, desc_sw32(stage(s) + T::OFF_MUX + c * BM * 32 + wg * 64 * 32),\n",
                 "          acc[c] += static_cast<int32_t>(\n"),
    "NO_CLUSTER": ("os_mma_sm90.cuh", "constexpr int CLUSTER = 2;", "constexpr int CLUSTER = 1;"),
})
WGMMA_VARIANTS = {"as built": (), "no mux": ("NO_MUX",), "no wgmma": ("NO_WGMMA",),
                  "no mux, no wgmma": ("NO_MUX", "NO_WGMMA"), "no cluster": ("NO_CLUSTER",)}
WGMMA_ROWS = (64, 128, 256, 1024, 2048)
_NO_A = ("NO_A", "NO_GATHER")
VARIANTS = {"as built": (), "no B loads": ("NO_B",), "no A copies": _NO_A, "no mma": ("NO_MMA",),
            "no A, no B": (*_NO_A, "NO_B"), "no A, no mma": (*_NO_A, "NO_MMA"),
            "no B, no mma": ("NO_B", "NO_MMA"), "no A, no B, no mma": (*_NO_A, "NO_B", "NO_MMA"),
            "no zero test": ("NO_ZERO_TEST",)}
# (images, H, W, C, F) of l1, l3 and l7 at batch 64; 3x3 taps, stride 1
# ResNet-50 v1.5's 1 x 1 stride-1 convs at batch 64: (M = 64*H*W, K = C, N = F)
CONV1X1 = {"s1.c1": (64 * 56 * 56, 256, 64), "s1.c3": (64 * 56 * 56, 64, 256),
           "s4.c1": (64 * 7 * 7, 2048, 512), "s4.c3": (64 * 7 * 7, 512, 2048)}
CONVS = {"l1": (64, 64, 64, 64, 64), "l3": (64, 32, 32, 128, 128), "l7": (64, 8, 8, 512, 512)}
HEAD = (64, 512, 1000)  # (M, K, N)
NNZ = 3


def variant_sources(name: str, switches, csrc: Path = build.CSRC) -> Path:
    """A copy of ``csrc`` (the sources as committed) with ``switches``
    applied: those of ``SWITCHES`` to os_mma.cuh, those of
    ``SOURCE_SWITCHES`` to their own source."""
    out = build.build_dir() / "ablation" / name.replace(" ", "_").replace(",", "")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for sw in switches:
        source, anchor, replacement = (("os_mma.cuh", *SWITCHES[sw]) if sw in SWITCHES
                                       else SOURCE_SWITCHES[sw])
        path = out / source
        text = path.read_text()
        if text.count(anchor) != 1:
            raise RuntimeError(f"{sw}: its anchor is not in {source} once")
        path.write_text(text.replace(anchor, replacement))
    return out


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("mma_ablation: no CUDA card available", file=sys.stderr)
        return 2
    parts = set(argv) or {"int8", "stem", "bf16", "wgmma"}
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    if parts == {"conv1x1"}:
        _conv1x1_table(gen, dev)
        return 0

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    def weight(k, f):
        nb = k // 8
        pos = torch.argsort(torch.rand(nb, 8, f, generator=gen), dim=1)[:, :NNZ]
        return codes(nb, NNZ, f), pos.sort(dim=1).values.to(torch.int8).to(dev)

    stream = torch.cuda.current_stream(dev).cuda_stream

    def rows(m):  # the int8 tile rows the rule takes (core.mma_plan)
        return mma_plan("ablation", m, 8, 8, 0).tile_rows

    cases = []
    # the convs as served: dequantize, bias, ReLU, requantize to int8 codes,
    # scaled so the codes spread over about +-40 and half of them are zero
    for mode in ("bw", "tc"):
        for n, h, w, c, f in CONVS.values():
            x, (v, idx) = codes(n, h, w, c), weight(9 * c, f)
            if mode == "tc":  # one pattern (nb, nnz) shared by every column
                idx = idx[:, :, 0].contiguous()
            kc = 9 * c // 8 * NNZ
            scale = ((torch.rand(f, generator=gen) + 1.0) / (2900.0 * kc ** 0.5)).to(dev)
            bias = (0.5 * torch.randn(f, generator=gen)).to(dev)
            out_scale = torch.full((f,), 0.05, device=dev)
            out = torch.empty(n * h * w * f, dtype=torch.int8, device=dev)
            args = (x.data_ptr(), v.data_ptr(), idx.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    out_scale.data_ptr(), 1, out.data_ptr(), 0, 2, n, h, w, c, f, h, w, 3, 3, 1, 1,
                    1, 1, 8, NNZ, *((1,) if mode == "bw" else ()), rows(n * h * w), stream)
            cases.append((f"vdbb_conv_{mode}", args, (x, v, idx, scale, bias, out_scale, out)))
    m, k, n = HEAD
    a, (v, idx) = codes(m, k), weight(k, n)
    out = torch.empty(m * n, dtype=torch.int32, device=dev)
    cases.append(("vdbb_matmul_bw", (a.data_ptr(), v.data_ptr(), idx.data_ptr(), None, None,
                                     None, 0, out.data_ptr(), 0, 0, m, k, n, 8, NNZ, 1, rows(m),
                                     stream),
                  (a, v, idx, out)))
    # the tc head: one pattern (nb, nnz) shared by every column
    tc_idx = idx[:, :, 0].contiguous()
    cases.append(("vdbb_matmul_tc", (a.data_ptr(), v.data_ptr(), tc_idx.data_ptr(), None, None,
                                     None, 0, out.data_ptr(), 0, 0, m, k, n, 8, NNZ, rows(m), 1,
                                     stream),
                  (a, v, tc_idx, out)))

    argtypes = {name: build.KERNELS[name].argtypes
                for name in ("vdbb_conv_bw", "vdbb_conv_tc", "vdbb_matmul_bw", "vdbb_matmul_tc")}
    sources = {name: f"{name}.cu" for name in argtypes}
    columns = [f"{mode} {layer}" for mode in ("bw", "tc") for layer in CONVS] + ["bw head", "tc head"]
    csrc, registry = build.CSRC, dict(build.KERNELS)
    try:
        if "int8" in parts:
            print(f"{'variant':<20s} " + " ".join(f"{name:>9s}" for name in columns)
                  + "   (device ms; convs int8 codes out, heads raw int32 out)")
            for name, switches in VARIANTS.items():
                print(f"{name:<20s} " + _row(name, switches, csrc, cases, sources, argtypes),
                      flush=True)
        if "bf16" in parts:
            _bf16_table(csrc, gen, dev, stream)
        if "wgmma" in parts:
            _wgmma_table(csrc, gen, dev, stream)
        if "stem" not in parts:
            return 0
        # the stem on its direct path: fp32 in, bias, ReLU, int8 codes out
        n, h, w, c, f = STEM
        x = torch.randn(n, h, w, c, generator=gen).to(dev)
        wt = (0.2 * torch.randn(3, 3, c, f, generator=gen)).to(dev)
        bias, out_scale = torch.randn(f, generator=gen).to(dev), torch.full((f,), 0.05, device=dev)
        out = torch.empty(n * h * w * f, dtype=torch.int8, device=dev)
        stem = [("im2col_conv", (x.data_ptr(), wt.data_ptr(), None, bias.data_ptr(),
                                 out_scale.data_ptr(), relu, out.data_ptr(), 1, 2, n, h, w, c, f,
                                 h, w, 3, 3, 1, 1, 1, 1, 1, stream), (x, wt, bias, out_scale, out))
                for relu in (1, 0)]
        stem_src = {"im2col_conv": "im2col_conv.cu"}
        stem_types = {"im2col_conv": [P, P, P, P, P, I, P, I, I] + [I] * 14 + [P]}
        print(f"{'stem variant':<22s} {'ReLU':>9s} {'no ReLU':>9s} {'ReLU':>9s} {'no ReLU':>9s}"
              "   (device ms by profiler, then by events; int8 codes out)")
        for name, switches in STEM_VARIANTS.items():
            print(f"{name:<22s} " + _row(f"stem {name}", switches, csrc, stem, stem_src,
                                         stem_types, events=True), flush=True)
    finally:
        build.CSRC = csrc
        build.KERNELS.clear()
        build.KERNELS.update(registry)
    return 0


def _bf16_table(csrc, gen, dev, stream) -> None:
    """The bf16 core at every LM shape and row count, bf16 out, as built
    and with each of ``BF16_VARIANTS``' parts switched off."""
    cases = []
    for k, n in LM_SHAPES.values():
        nb = k // 8
        pos = torch.argsort(torch.rand(nb, 8, generator=gen), dim=1)[:, :NNZ]
        idx = pos.sort(dim=1).values.to(torch.int8).to(dev)
        v = (torch.randn(nb, NNZ, n, generator=gen) * k ** -0.5).bfloat16().to(dev)
        for m in LM_ROWS:
            a = torch.randn(m, k, generator=gen).bfloat16().to(dev)
            out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
            plan = bf16_mma_plan("ablation", m, n, nb * NNZ, (a.data_ptr(), v.data_ptr()), k=k)
            cases.append(("vdbb_matmul_tc", (a.data_ptr(), v.data_ptr(), idx.data_ptr(), None, None,
                                             None, 0, out.data_ptr(), 2, 3, m, k, n, 8, NNZ,
                                             plan.tile_rows, plan.split, stream),
                          (a, v, idx, out)))
    columns = [f"{s}:{m}" for s in LM_SHAPES for m in LM_ROWS]
    sources = {"vdbb_matmul_tc": "vdbb_matmul_tc.cu"}
    argtypes = {"vdbb_matmul_tc": build.KERNELS["vdbb_matmul_tc"].argtypes}
    print(f"{'bf16 variant':<20s} " + " ".join(f"{c:>12s}" for c in columns)
          + "   (device ms; bf16 out)")
    for name, switches in BF16_VARIANTS.items():
        print(f"{name:<20s} " + _row(f"bf16 {name}", switches, csrc, cases, sources, argtypes,
                                     width=12), flush=True)


def _wgmma_table(csrc, gen, dev, stream) -> None:
    """The wgmma core at every LM shape and row count, fp32 out (the plan's
    dequant flush), as built and with each of ``WGMMA_VARIANTS``' parts
    switched off; then os_mma.cuh's instance at the rule's tile rows, and
    the least time of each (ops at 1 979 TOPS)."""
    from repro_torch.kernels import vdbb_matmul as mm

    cases, old = [], []
    for k, n in LM_SHAPES.values():
        nb = k // 8
        pos = torch.argsort(torch.rand(nb, 8, generator=gen), dim=1)[:, :NNZ]
        idx = pos.sort(dim=1).values.to(torch.int8).to(dev)
        v = torch.randint(-127, 128, (nb, NNZ, n), generator=gen, dtype=torch.int8).to(dev)
        vt, sel = mm.kmajor_values(v), mm.mux_selectors(idx, NNZ)
        scale = torch.full((n,), 1e-4, device=dev)
        for m in WGMMA_ROWS:
            a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).to(dev)
            out = torch.empty(m, n, device=dev)
            keep = (a, v, idx, vt, sel, scale, out)
            cases.append(("vdbb_matmul_tc_wgmma",
                          (a.data_ptr(), vt.data_ptr(), sel.data_ptr(), scale.data_ptr(), None,
                           None, 0, out.data_ptr(), 1, m, k, n, vt.stride(0), 8, NNZ, stream),
                          keep))
            old.append(("vdbb_matmul_tc",
                        (a.data_ptr(), v.data_ptr(), idx.data_ptr(), scale.data_ptr(), None, None,
                         0, out.data_ptr(), 0, 1, m, k, n, 8, NNZ,
                         mma_plan("ablation", m, 8, 8, 0).tile_rows, 1, stream), keep))
    columns = [f"{s}:{m}" for s in LM_SHAPES for m in WGMMA_ROWS]
    entry = build.KERNELS["vdbb_matmul_tc"].entries["wgmma"]
    sources = {"vdbb_matmul_tc_wgmma": "vdbb_matmul_tc.cu", "vdbb_matmul_tc": "vdbb_matmul_tc.cu"}
    argtypes = {"vdbb_matmul_tc_wgmma": entry[1],
                "vdbb_matmul_tc": build.KERNELS["vdbb_matmul_tc"].argtypes}
    print(f"{'wgmma variant':<20s} " + " ".join(f"{c:>12s}" for c in columns)
          + "   (device ms; fp32 out)")
    for name, switches in WGMMA_VARIANTS.items():
        print(f"{name:<20s} " + _row(f"wgmma {name}", ("ONE_NNZ",) + switches, csrc, cases,
                                     sources, argtypes, width=12), flush=True)
    print(f"{'os_mma.cuh mma.sync':<20s} " + _row("wgmma os_mma", ("ONE_NNZ",), csrc, old,
                                                   sources, argtypes, width=12), flush=True)
    least = [2 * m * (k // 8 * NNZ) * n / 1979e12 * 1e3 for k, n in LM_SHAPES.values()
             for m in WGMMA_ROWS]
    print(f"{'least (1 979 TOPS)':<20s} " + " ".join(f"{t:12.4f}" for t in least), flush=True)


def _conv1x1_table(gen, dev) -> None:
    """The 1 x 1 stride-1 convs of ``CONV1X1`` staged on the tc conv
    (``TapMux``, the rule's tile rows) and on the tc matmul (the rule's
    core: wgmma above 64 rows), int8 codes out with bias and ReLU; device
    ms by torch.profiler, and the least time (ops at 1 979 TOPS, bytes at
    3.35 TB/s)."""
    from repro_torch.core.vdbb import DBBFormat, dbb_encode_conv
    from repro_torch.kernels import vdbb_im2col_conv as vc
    from repro_torch.kernels import vdbb_matmul as mm

    fmt = DBBFormat(8, NNZ, "matrix")
    rows = {"tc conv (TapMux)": [], "tc matmul (rule)": [], "least": []}
    for m, k, n in CONV1X1.values():
        dw = dbb_encode_conv(torch.randn(1, 1, k, n, generator=gen), fmt, prune=True)
        dw = type(dw)(dw.values.mul(40).round().clamp(-127, 127).to(torch.int8).to(dev),
                      dw.indices.to(dev), dw.fmt, dw.shape)
        x = torch.randint(0, 40, (m, k), generator=gen, dtype=torch.int8).to(dev)
        kc = k // 8 * NNZ
        ep = dict(scales=torch.full((n,), 1.0 / (1600 * kc ** 0.5), device=dev),
                  bias=(0.1 * torch.randn(n, generator=gen)).to(dev), relu=True, out_scale=0.05)
        x4 = x.view(64, -1, 1, k)
        conv, _ = vc.stage_vdbb_im2col_conv(dw, 1, 1, tuple(x4.shape), padding="VALID", **ep)
        gemm, _ = mm.stage_vdbb_matmul(dw, m, **ep)
        if not torch.equal(conv(x4).view(m, n), gemm(x)):
            raise AssertionError(f"the two routes disagree at {(m, k, n)}")
        rows["tc conv (TapMux)"].append(device_ms(lambda: conv(x4)))
        rows["tc matmul (rule)"].append(device_ms(lambda: gemm(x)))
        rows["least"].append(1e3 * max(2 * m * kc * n / 1979e12,
                                       (m * k + m * n + kc * n) / 3.35e12))
    print(f"{'1x1 route':<20s} " + " ".join(f"{c:>12s}" for c in CONV1X1)
          + "   (device ms; int8 codes out, bias, ReLU; batch 64)")
    for name, ts in rows.items():
        print(f"{name:<20s} " + " ".join(f"{t:12.4f}" if t is not None else f"{'none':>12s}"
                                         for t in ts), flush=True)


def _row(name, switches, csrc, cases, sources, argtypes, events=False, width=9) -> str:
    """Build the variant's copy of ``csrc`` and time each case on it (by
    torch.profiler, and with ``events`` by CUDA events as well)."""
    build.CSRC = variant_sources(name, switches, csrc)
    kernels = {kn: build.CudaKernel(kn, sources[kn], argtypes[kn], replaces="ablation")
               for kn in sources}
    build.build_all(tuple(sources.values()))
    calls = [lambda kn=kn, args=args: kernels[kn].launch(*args) for kn, args, _ in cases]
    row = [device_ms(fn) for fn in calls] + ([event_ms(fn) for fn in calls] if events else [])
    return " ".join(f"{t:{width}.4f}" if t is not None else f"{'none':>{width}s}" for t in row)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
