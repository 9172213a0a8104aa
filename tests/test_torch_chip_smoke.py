"""``chip_smoke.py``'s attribution of CUDA kernel names to the port's
kernels, on the CPU. The names are built from the GEMM templates' own
loader and stager names, demangled as torch.profiler prints them and
mangled as ``ptxas -v`` does. Loading the script runs nothing: its work is
under ``if __name__ == "__main__"``."""
import importlib.util
from pathlib import Path

import pytest

from torch_parity import one_torch_thread  # noqa: F401  (autouse: the rehearsals' torch ops)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mma(rows, chunk, out, stage_a, stage_b="ExpandTile"):
    return (f"void os_mma::kernel<{rows}, {chunk}, {out}, {stage_a}, {stage_b}>"
            f"({stage_a}, {stage_b}, int, int, int, {out}*, EpilogueArgs)")


def _direct(out):
    return (f"void direct_conv::kernel<{out}>(direct_conv::HaloTile, float const*, int, int, "
            f"{out}*, EpilogueArgs)")


def _bf16(rows, chunk, out):
    return (f"void bf16_mma::kernel<{rows}, 128, {chunk}, {out}, bf16_mma::WordGather>"
            f"(bf16_mma::WordGather, bf16_mma::Args)")


def _gemm(t, out, load_a, load_b):
    return (f"void os_gemm::kernel<{t}, {out}, {load_a}, {load_b}>"
            f"({load_a}, {load_b}, int, int, int, {out}*, EpilogueArgs)")


NAMES = [
    # the int8 tensor-core core: both tile instances, both chunk widths, every output
    *[(_mma(r, c, o, "TapChunks"), "vdbb_conv_bw")
      for r in (64, 128) for c in (8, 16) for o in ("int", "float", "signed char")],
    *[(_mma(r, c, o, "os_mma::RowChunks"), "vdbb_matmul_bw")
      for r in (64, 128) for c in (8, 16) for o in ("int", "float", "signed char")],
    ("_ZN6os_mma6kernelILi128ELi16Ea9TapChunks10ExpandTileEEvT2_T3_iiiPT1_12EpilogueArgs",
     "vdbb_conv_bw"),
    ("_ZN6os_mma6kernelILi64ELi8EiNS_9RowChunksE10ExpandTileEEvT2_T3_iiiPT1_12EpilogueArgs",
     "vdbb_matmul_bw"),
    # the tc head's int8 path: the gather stager on the same core, both tiles
    *[(_mma(r, 8, o, "GatherMux", "DenseTile"), "vdbb_matmul_tc")
      for r in (64, 128) for o in ("int", "float", "signed char")],
    ("_ZN6os_mma6kernelILi64ELi8Ef9GatherMux9DenseTileEEvT2_T3_iiiPT1_12EpilogueArgs",
     "vdbb_matmul_tc"),
    ("_ZN6os_mma6kernelILi128ELi8Ea9GatherMux9DenseTileEEvT2_T3_iiiPT1_12EpilogueArgs",
     "vdbb_matmul_tc"),
    # the tc conv's int8 path: the tap gather stager on the same core, both tiles
    *[(_mma(r, 8, o, "TapMux", "DenseTile"), "vdbb_conv_tc")
      for r in (64, 128) for o in ("int", "float", "signed char")],
    ("_ZN6os_mma6kernelILi128ELi8Ea6TapMux9DenseTileEEvT2_T3_iiiPT1_12EpilogueArgs",
     "vdbb_conv_tc"),
    ("_ZN6os_mma6kernelILi64ELi8Ef6TapMux9DenseTileEEvT2_T3_iiiPT1_12EpilogueArgs",
     "vdbb_conv_tc"),
    # the stem's direct conv, both outputs
    (_direct("signed char"), "im2col_conv"),
    (_direct("float"), "im2col_conv"),
    ("_ZN11direct_conv6kernelIaEEvNS_8HaloTileEPKfiiPT_12EpilogueArgs", "im2col_conv"),
    ("_ZN11direct_conv6kernelIfEEvNS_8HaloTileEPKfiiPT_12EpilogueArgs", "im2col_conv"),
    # the CUDA-core core: every kernel's loaders
    (_gemm("float", "float", "Tap<float>", "ExpandTaps<float>"), "vdbb_conv_bw"),
    (_gemm("float", "float", "os_gemm::DenseB<float>", "ExpandCols<float>"), "vdbb_matmul_bw"),
    (_gemm("signed char", "signed char", "GatherTap<signed char>", "os_gemm::DenseB<signed char>"),
     "vdbb_conv_tc"),
    (_gemm("signed char", "float", "GatherCols<signed char>", "os_gemm::DenseB<signed char>"),
     "vdbb_matmul_tc"),
    (_gemm("float", "signed char", "GatherTap", "os_gemm::DenseB<float>"), "vdbb_conv_tc"),
    ("_ZN7os_gemm6kernelIfa9GatherTapNS_6DenseBIfEEEEvT1_T2_iiiPT0_12EpilogueArgs",
     "vdbb_conv_tc"),
    (_gemm("float", "signed char", "Tap<float>", "os_gemm::DenseB<float>"), "im2col_conv"),
    ("_ZN7os_gemm6kernelIfa3TapIfE10ExpandTapsIfEEEvT1_T2_iiiPT0_12EpilogueArgs", "vdbb_conv_bw"),
    ("_ZN7os_gemm6kernelIffNS_6DenseBIfEE10ExpandColsIfEEEvT1_T2_iiiPT0_12EpilogueArgs",
     "vdbb_matmul_bw"),
    # the tc matmul's bf16 instantiation (the LM's projections) on the bf16
    # tensor-core core: both tile instances, both B chunks, every output
    *[(_bf16(r, c, o), "vdbb_matmul_tc_bf16")
      for r in (16, 128) for c in (16, 2) for o in ("__nv_bfloat16", "float", "signed char")],
    ("_ZN8bf16_mma6kernelILi16ELi128ELi16E13__nv_bfloat16NS_10WordGatherEEEvT3_NS_4ArgsE",
     "vdbb_matmul_tc_bf16"),
    ("_ZN8bf16_mma6kernelILi128ELi128ELi2EaNS_10WordGatherEEEvT3_NS_4ArgsE",
     "vdbb_matmul_tc_bf16"),
    # anything else is not the port's
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>>", "other"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc", "other"),
]


@pytest.mark.parametrize("name,kernel", NAMES)
def test_kernel_family_attributes_each_instance(smoke, name, kernel):
    assert smoke.kernel_family(name) == kernel
    assert smoke.port_kernel(name) == (kernel != "other")


def test_kernel_family_names_only_registered_kernels(smoke):
    from repro_torch.kernels import build, ops  # noqa: F401  (registers the kernels)

    for loaders in smoke.KERNEL_OF_LOADER.values():
        assert set(loaders.values()) <= set(build.launch_counts())


def test_no_stager_name_is_part_of_another(smoke):
    """Names are matched as substrings: within a template, no stager's name
    may lie inside another's, and no template's name inside another's."""
    cores = list(smoke.KERNEL_OF_LOADER)
    for core in cores:
        assert not any(core != other and core in other for other in cores)
    for core, loaders in smoke.KERNEL_OF_LOADER.items():
        names = list(loaders)
        for i, name in enumerate(names):
            # an earlier name inside a later one would take its matches
            assert not any(earlier in name for earlier in names[:i]), (core, name)


def test_stager_names_are_the_templates(smoke):
    """The names matched are the structs the sources pass to the cores."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    text = "".join(p.read_text() for p in csrc.glob("*.cu*"))
    for loaders in smoke.KERNEL_OF_LOADER.values():
        for loader in loaders:
            assert f"struct {loader} " in text, loader


@pytest.mark.parametrize("names,seen", [
    (set(), None),
    ({_mma(128, 8, "float", "GatherMux", "DenseTile")}, None),
    ({_mma(128, 8, "signed char", "TapMux", "DenseTile"), _direct("signed char")},
     _mma(128, 8, "signed char", "TapMux", "DenseTile"))])
def test_require_instance_fails_unless_it_sees_the_instance(smoke, monkeypatch, names, seen):
    """The smoke's evidence that a path ran its kernel: a profiler pass with
    no kernel events fails it as a pass without the instance does."""
    monkeypatch.setattr(smoke, "kernel_names", lambda fn: names)
    if seen is None:
        with pytest.raises(AssertionError):
            smoke.require_instance(lambda: None, "os_mma", "TapMux", "tc l1")
    else:
        assert smoke.require_instance(lambda: None, "os_mma", "TapMux", "tc l1") == seen


def _rehearse(smoke, monkeypatch):
    """Stub what only a card gives for a CPU rehearsal of phases 7 and 8 at
    the smoke configs' size: the plain versions stand in for the kernels, so
    the timers, the profiler, the CUDA memory calls and the launch counts
    (counted here by dtype at the tc matmul's wrapper, and a plan replay's
    from the model) are stubbed. Returns the CPU device."""
    import torch

    from repro_torch.kernels import build, ops  # noqa: F401  (registers the kernels)
    from repro_torch.kernels import timing
    from repro_torch.kernels import vdbb_matmul as mm
    from repro_torch.launch import serve

    monkeypatch.setattr(timing, "event_ms",
                        lambda fn, reps=20, warmup=3, device="cuda": (fn(), 0.1)[1])
    monkeypatch.setattr(timing, "device_ms", lambda fn, keep=None, reps=5, passes=3: (fn(), 0.1)[1])
    monkeypatch.setattr(smoke, "profile_forwards",
                        lambda fn, x, per, reps=4: (fn(x), {"device_ms": None})[1])
    for name in ("empty_cache", "reset_peak_memory_stats", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    monkeypatch.setattr(smoke, "LM_SMOKE", True)
    monkeypatch.setattr(smoke, "LM_SHAPES", {"wq/wo": (128, 128, 2), "wk/wv": (128, 32, 2),
                                             "w_up": (128, 256, 1), "w_down": (256, 128, 1)})
    monkeypatch.setattr(smoke, "MOE_SHAPES", {"wq/wk/wv/wo": (128, 128, 4),
                                              "w_up/w_gate": (128, 512, 2),
                                              "w_down": (512, 128, 1)})
    monkeypatch.setattr(smoke, "LM_ROWS", {"decode": 2, "prefill": 32})
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    monkeypatch.setattr(smoke, "LM_GEN", 8)
    monkeypatch.setattr(smoke, "LM_KEEP", (0, 6))
    plain = mm.vdbb_matmul_tc

    def counted(a, *args, **kw):
        mm.KERNEL.counts["bf16" if a.dtype == torch.bfloat16 else ""] += 1
        return plain(a, *args, **kw)

    monkeypatch.setattr(mm, "vdbb_matmul_tc", counted)
    serve_plan = serve.serve_lm_plan

    def with_replay(*a, **kw):
        rec = serve_plan(*a, **kw)
        replay = dict.fromkeys(build.KERNELS, 0)
        rec["graph_launches"] = {"cpu": dict(replay, vdbb_matmul_tc=smoke.projections(rec["model"]))}
        return rec

    monkeypatch.setattr(serve, "serve_lm_plan", with_replay)
    return torch.device("cpu")


def test_lm_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """Phase 7 end to end on the CPU at the smoke config's size."""
    import torch

    from repro_torch.kernels import build

    cpu = _rehearse(smoke, monkeypatch)
    recs = smoke.lm_kernels(torch.Generator().manual_seed(1), cpu)
    assert len(recs["bf16"]) == len(recs["int8"]) == 8
    gen = smoke.lm_generate(cpu)
    # the stubbed timer calls each function once: two prefills (the timed
    # one and the kept one) and eight decode steps (a warm-up and seven);
    # on the CPU nothing is captured, so every forward is counted as it runs
    assert gen["compressed"]["launches"]["vdbb_matmul_tc_bf16"] == 12 * (2 + 8)
    assert gen["compressed"]["captures"] == 2 and gen["compressed"]["graph_equals_eager"]
    assert gen["dense"]["decode_bound_ms"] > gen["compressed"]["decode_bound_ms"]
    assert set(gen["compressed"]["consistency_rel_l2"]) == {0, 6}
    assert smoke.lm_plan(cpu)["captures"] == 1
    smoke.lm_golden(cpu)
    build.reset_launches()


def test_moe_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """Phase 8 end to end on the CPU at moonshot's smoke config: the
    kernels at its (stubbed, small) shapes, generation compressed and dense
    without the fresh-forward gate, the routed experts' record, the JAX
    fixture and the INT8 plan."""
    import torch

    from repro_torch.kernels import build

    cpu = _rehearse(smoke, monkeypatch)
    recs = smoke.lm_kernels(torch.Generator().manual_seed(1), cpu, smoke.MOE_SHAPES,
                            dtypes=("bf16",), layers=48)
    assert list(recs) == ["bf16"] and len(recs["bf16"]) == 6
    gen = smoke.lm_generate(cpu, smoke.MOE_ARCH, fresh_gate=None)
    # 2 layers of q, k, v, o and the shared experts' up, gate, down
    assert gen["compressed"]["launches"]["vdbb_matmul_tc_bf16"] == 14 * (2 + 8)
    assert gen["compressed"]["consistency_rel_l2"] == {}
    experts = gen["compressed"]["experts"]
    assert experts["bound_ms"] > 0 and experts["layer_device_ms"] is None
    assert gen["dense"]["decode_bound_ms"] > gen["compressed"]["decode_bound_ms"]
    smoke.smoke_golden(cpu)
    assert smoke.lm_plan(cpu, smoke.MOE_ARCH)["captures"] == 1
    build.reset_launches()


def test_lm_kernels_carry_a_missing_device_time(smoke, monkeypatch):
    """A profiler that delivers no record of a shape's call leaves that
    shape's device time None, and the per-layer sums None with it, instead
    of failing the phase."""
    import torch

    from repro_torch.kernels import build, timing

    cpu = _rehearse(smoke, monkeypatch)
    monkeypatch.setattr(timing, "device_ms", lambda fn, keep=None, reps=5, passes=3: (fn(), None)[1])
    recs = smoke.lm_kernels(torch.Generator().manual_seed(1), cpu,
                            {"square": (128, 128, 2), "up": (128, 256, 1)})
    for by_shape in recs.values():
        assert all(r["device_ms"] is None and r["bound_ms"] > 0 for r in by_shape.values())
    build.reset_launches()


@pytest.mark.parametrize("delivered, passes, expect_ms", [
    ((5, 5, 5), 3, 0.1),  # every pass delivers: the first three are taken
    ((0, 0, 0, 0, 5), 5, 0.1),  # the first four deliver nothing: a fifth does
    ((0,) * 9, 9, None),  # none of the 3 + 6 passes delivers a record
])
def test_device_ms_runs_more_passes_while_none_delivers(monkeypatch, delivered, passes,
                                                       expect_ms):
    """``timing.device_ms`` on a stubbed profiler whose passes deliver the
    given numbers of 100 us records of one kernel (5 calls a pass)."""
    from types import SimpleNamespace

    import torch
    import torch.profiler

    from repro_torch.kernels import timing

    counts, ran = iter(delivered), []

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            n = next(counts)
            ran.append(n)
            ev = SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, name="kernel",
                                 time_range=SimpleNamespace(start=0.0, end=100.0))
            self._events = [ev] * n
            return False

        def events(self):
            return self._events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    got = timing.device_ms(lambda: None)
    assert len(ran) == passes
    assert got == expect_ms if expect_ms is None else got == pytest.approx(expect_ms)


def test_recurrent_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """Phase 9 end to end on the CPU at the smoke configs' size: each
    recurrent decoder's kernels at (stubbed, small) shapes, generation
    compressed and dense with the fresh-forward gate, the decode bound,
    its JAX fixture and the INT8 plan."""
    import torch

    from repro_torch.kernels import build

    cpu = _rehearse(smoke, monkeypatch)
    monkeypatch.setattr(smoke, "RECURRENT_SHAPES", {
        arch: {"square": (128, 128, 1), "up": (128, 256, 1)} for arch in smoke.RECURRENT_ARCHS})
    out = smoke.recurrent_phase(torch.Generator().manual_seed(1), cpu)
    # compressed projections a forward: recurrentgemma's smoke config has 6
    # RG-LRU blocks of 5, 2 local-attention blocks of 4 and 8 MLPs of 3;
    # rwkv6's 2 blocks of 5 (time mix) and 3 (channel mix)
    for arch, per in (("recurrentgemma-2b", 62), ("rwkv6-3b", 16)):
        r = out[arch]
        assert len(r["kernels"]["bf16"]) == len(r["kernels"]["int8"]) == 4
        gen = r["generate"]
        assert gen["compressed"]["launches"]["vdbb_matmul_tc_bf16"] == per * (2 + 8)
        # the gate on an fp32 copy of the weights, the served model's logged
        assert set(gen["compressed"]["consistency_rel_l2"]) == {0, 6}
        assert set(gen["compressed"]["served_consistency_rel_l2"]) == {0, 6}
        assert max(gen["compressed"]["consistency_rel_l2"].values()) < 1e-4
        assert gen["dense"]["decode_bound_ms"] > gen["compressed"]["decode_bound_ms"]
        assert r["plan"]["captures"] == 1
    build.reset_launches()


def test_mla_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """Phase 10 end to end on the CPU at deepseek-v3-671b's smoke config:
    the kernels at (stubbed, small) shapes, generation compressed and dense
    with the mixer gate in place of a fresh forward, the JAX fixture with
    its quantized forward, and the INT8 plan."""
    import torch

    from repro_torch.kernels import build

    cpu = _rehearse(smoke, monkeypatch)
    monkeypatch.setattr(smoke, "MLA_SHAPES", {"square": (128, 128, 1), "up": (128, 256, 1)})
    out = smoke.mla_phase(torch.Generator().manual_seed(1), cpu)
    assert len(out["kernels"]["bf16"]) == len(out["kernels"]["int8"]) == 4
    gen = out["generate"]
    # 2 layers of wq_a, wq_b, wkv_a, wkv_b, wo and the shared expert's up,
    # gate, down at prefill (two prefills); decode (eight steps) skips wkv_b
    assert gen["compressed"]["launches"]["vdbb_matmul_tc_bf16"] == 16 * 2 + 14 * 8
    assert gen["compressed"]["consistency_rel_l2"] == {}
    for label in ("compressed", "dense"):
        mixer = gen[label]["mixer_consistency_rel_l2"]
        assert mixer["fp32"] < 1e-6 and mixer["served"] < 2e-2
    assert gen["dense"]["decode_bound_ms"] > gen["compressed"]["decode_bound_ms"]
    assert out["plan"]["captures"] == 1
    build.reset_launches()


def test_decode_bound_counts_the_tied_table_and_the_state(smoke, monkeypatch):
    """The bytes of a decode step: recurrentgemma reads its whole tied
    table and only its local blocks hold K/V; rwkv6 reads and writes its
    state; starcoder2 reads B rows of its table and every layer's K/V;
    deepseek reads its decoded wkv_b and the latent cache."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models.model import LM

    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    monkeypatch.setattr(smoke, "LM_GEN", 8)

    def bound_bytes(arch):
        cfg = smoke_config(arch)
        model = LM(cfg).init(torch.Generator().manual_seed(0), "cpu", compress=True)
        weights = smoke.tensor_bytes(model.state(), skip=("embed",))
        return cfg, weights, smoke.decode_bound(model)[1]

    cfg, weights, total = bound_bytes("recurrentgemma-2b")
    table = cfg.padded_vocab * cfg.d_model * 2
    kv = 2 * 2 * 2 * min(cfg.local_window, 24) * cfg.num_kv_heads * cfg.hd * 2  # 2 local blocks
    state = 2 * 6 * (2 * cfg.d_rnn_ * 4 + 2 * (cfg.conv1d_width - 1) * cfg.d_rnn_ * 2)
    assert total == weights + table + kv + state
    cfg, weights, total = bound_bytes("rwkv6-3b")
    state = 2 * cfg.num_layers * 2 * (cfg.rwkv_heads * cfg.rwkv_head_dim ** 2 * 4
                                      + 2 * cfg.d_model * 2)
    assert total == weights + 2 * cfg.d_model * 2 + state
    cfg, weights, total = bound_bytes("starcoder2-7b")
    kv = 2 * cfg.num_layers * 2 * 24 * cfg.num_kv_heads * cfg.hd * 2
    assert total == weights + 2 * cfg.d_model * 2 + kv
    # MLA: wkv_b read decoded to dense (r x H x (nope + v) bf16) in place of
    # its compressed leaf; c_kv and k_rope read whole, one slot written
    cfg, weights, total = bound_bytes("deepseek-v3-671b")
    model = LM(cfg).init(torch.Generator().manual_seed(0), "cpu", compress=True)
    leaf = smoke.tensor_bytes({"w": model.state()["layers"]["b0"]["mixer"]["wkv_b"]})
    decoded = cfg.num_layers * cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_dim
                                                                   + cfg.v_head_dim) * 2
    latent = cfg.num_layers * 2 * (24 + 1) * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    assert total == weights - leaf + decoded + 2 * cfg.d_model * 2 + latent


def test_side_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """Phase 11 end to end on the CPU at the smoke configs' size: each
    model's kernels at (stubbed, small) shapes and its phases' rows (the
    memory's for musicgen's cross wk/wv), generation compressed and dense
    with side inputs and the fresh-forward gate, its JAX fixture, and the
    INT8 prefill unplanned after the plan's refusal."""
    import torch

    from repro_torch.kernels import build

    cpu = _rehearse(smoke, monkeypatch)
    monkeypatch.setattr(smoke, "SIDE_SHAPES", {
        smoke.AUDIO_ARCH: {"square": (128, 128, 6, ("decode", "prefill")),
                           "cross wk/wv": (128, 128, 2, ("memory",))},
        smoke.VLM_ARCH: {"square": (128, 128, 2), "up": (128, 256, 1)}})
    out = smoke.side_phase(torch.Generator().manual_seed(1), cpu)
    audio, vlm = out[smoke.AUDIO_ARCH], out[smoke.VLM_ARCH]
    assert set(audio["kernels"]["bf16"]) == {("square", "decode"), ("square", "prefill"),
                                             ("cross wk/wv", "memory")}
    assert len(vlm["kernels"]["int8"]) == 4
    # the vision prompt: LM_PROMPT text tokens after the 8 vision positions
    assert (audio["prompt_len"], vlm["prompt_len"]) == (16, 24)
    # musicgen's 2 layers: 10 projections a prefill (two), 8 a decode step
    # (eight: the cross wk/wv run at prefill only); internvl2's 7 and 7
    for r, prefill, step in ((audio, 20, 16), (vlm, 14, 14)):
        gen = r["generate"]
        assert gen["compressed"]["launches"]["vdbb_matmul_tc_bf16"] == 2 * prefill + 8 * step
        assert set(gen["compressed"]["consistency_rel_l2"]) == {0, 6}
        assert max(gen["compressed"]["consistency_rel_l2"].values()) <= 2e-2
        assert gen["dense"]["decode_bound_ms"] > gen["compressed"]["decode_bound_ms"]
        int8 = r["int8"]
        assert int8["per_forward"] == prefill and "side inputs" in int8["refused"]
        assert int8["launches"]["vdbb_matmul_tc"] % prefill == 0
        assert int8["launches"]["vdbb_matmul_tc"] and not int8["launches"]["vdbb_matmul_tc_bf16"]
    build.reset_launches()


def test_projections_and_decode_bound_of_the_frontends(smoke, monkeypatch):
    """A musicgen decode step runs 8 of a layer's 10 compressed
    projections: the cross wk/wv ran at prefill. Its bound reads neither,
    reads B rows of each codebook's table, the self K/V at the phase's own
    prompt length and the cross K/V at cross_len slots, whatever the
    prompt. internvl2's step runs every projection."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models.model import LM

    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    monkeypatch.setattr(smoke, "LM_GEN", 8)
    cfg = smoke_config("musicgen-medium")
    model = LM(cfg).init(torch.Generator().manual_seed(0), "cpu", compress=True)
    assert smoke.projections(model) == 10 * cfg.num_layers
    assert smoke.projections(model, "decode") == 8 * cfg.num_layers
    state = model.state()
    weights = smoke.tensor_bytes(state, skip=("embed",))
    cross_w = sum(smoke.tensor_bytes({"w": state["layers"]["b0"]["cross"][n]})
                  for n in ("wk", "wv"))
    table = 2 * cfg.num_codebooks * cfg.d_model * 2
    kv = cfg.num_kv_heads * cfg.hd * 2  # a slot's K or V, bf16
    for plen in (16, 40):
        total = smoke.decode_bound(model, plen)[1]
        own = cfg.num_layers * 2 * 2 * (plen + 8) * kv
        cross = cfg.num_layers * 2 * 2 * cfg.cross_len * kv
        assert total == weights - cross_w + table + own + cross
    assert smoke.decode_bound(model)[1] == smoke.decode_bound(model, 16)[1]
    cfg = smoke_config("internvl2-2b")
    model = LM(cfg).init(torch.Generator().manual_seed(0), "cpu", compress=True)
    assert smoke.projections(model) == smoke.projections(model, "decode") == 7 * cfg.num_layers


def test_kernels_line_carries_every_key_for_every_kernel(smoke):
    """The JSON line from records shaped as phases 2–14 give them: one
    entry per counted kernel with every key the line promises, its source
    in the checkout, the bf16 and int8 tc matmul's records at each LM
    model's shapes, the frontends' included, beside their launches, and
    the launches of phase 14c's accounting."""
    import json

    from repro_torch.kernels import build, ops  # noqa: F401  (registers the kernels)

    def rec(err=0.0):
        return dict(err=err, ms=0.1, plain_ms=0.2, device_ms=0.05, bound_ms=0.01,
                    bound_by="bytes", library_ms=0.1, library_device_ms=None)

    def shapes():
        return {("wq", "decode"): rec(), ("wq", "prefill"): rec(0.01)}

    def generated(n):
        return {"compressed": {"launches": {"vdbb_matmul_tc_bf16": n},
                               "replay_launches": {"prefill": {"vdbb_matmul_tc_bf16": 10},
                                                   "decode": {"vdbb_matmul_tc_bf16": 8}}}}

    kernels = list(build.launch_counts())
    plan = {"launches": {"vdbb_matmul_tc": 7}, "replay_launches": {"vdbb_matmul_tc": 7}}
    decoders = {"rwkv6-3b": {"kernels": {"bf16": shapes(), "int8": shapes()},
                             "generate": generated(3), "plan": plan}}
    frontends = {arch: {"kernels": {"bf16": shapes(), "int8": shapes()},
                        "generate": generated(5),
                        "int8": {"launches": {"vdbb_matmul_tc": 40}, "per_forward": 8}}
                 for arch in smoke.SIDE_ARCHS}
    line = smoke.kernels_line(
        recs={k: [rec(), rec()] for k in kernels}, counts=dict.fromkeys(kernels, 2),
        planned={"matrix": {"replayed": {"vdbb_conv_tc": 7}}}, lm_recs={"bf16": shapes(),
                                                                        "int8": shapes()},
        lm_gen=generated(9), lm_planned=plan, moe_recs=shapes(), moe_gen=generated(4),
        decoders=decoders, frontends=frontends,
        selfheal={"launches": {"im2col_conv": 6, "vdbb_conv_tc": 42, "vdbb_matmul_tc": 6}},
        training={"cnn": {"matrix": {"launches": {"vdbb_conv_tc": 7, "vdbb_matmul_tc": 1}},
                          "None": {"launches": {"vdbb_conv_bw": 7}}},
                  "sparse_matmul_launches": {"vdbb_matmul_tc_bf16": 8}})
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert [e["name"] for e in line] == kernels
    for e in line:
        assert keys <= set(e) and e["route"] == "cuda" and (ROOT / e["source"]).is_file()
    by = {e["name"]: e for e in line}
    bf16, int8 = by["vdbb_matmul_tc_bf16"], by["vdbb_matmul_tc"]
    for arch in smoke.SIDE_ARCHS:
        assert bf16[arch]["launches"] == 5 and bf16[arch]["max_abs_err"] == 0.01
        assert bf16[arch]["graph_replay_launches"] == {"prefill": 10, "decode": 8}
        assert int8[arch]["launches"] == 40 and int8[arch]["launches_per_unplanned_prefill"] == 8
        assert int8[arch]["library_device_ms"] is None
    assert int8["rwkv6-3b"]["graph_replay_launches_per_prefill"] == 7
    assert bf16["moe"]["graph_replay_launches_per_step"] == 8
    assert int8["selfheal_launches"] == 6 and by["vdbb_conv_tc"]["selfheal_launches"] == 42
    assert by["vdbb_conv_bw"]["selfheal_launches"] == 0
    assert by["vdbb_conv_bw"]["accounting_launches"] == 7 and bf16["accounting_launches"] == 8
    assert by["im2col_conv"]["accounting_launches"] == 0
    json.loads(json.dumps({"kernels": line}))


def test_selfheal_phase_rehearses_on_the_cpu(smoke, monkeypatch, tmp_path):
    """Phase 12 end to end on the CPU at sparse-cnn-s's smoke config
    (buckets 1 … 8, 96 requests, a reload every 24): the checkpoints and
    the reference's, three reloads under traffic and a corrupted one, the
    restarts and the crash loop, the demotion and promotion of bucket 8.
    The CUDA synchronize and memory calls are stubbed, and the launch counts
    (the plain versions count nothing) are those of a replay's captures."""
    import torch

    from repro_torch.kernels import build

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for name in ("memory_reserved", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    monkeypatch.setattr(build, "launch_counts",
                        lambda: {"im2col_conv": 7, "vdbb_conv_tc": 21, "vdbb_matmul_tc": 7,
                                 "vdbb_matmul_tc_bf16": 0, "vdbb_conv_bw": 0,
                                 "vdbb_matmul_bw": 0})
    monkeypatch.setattr(smoke, "SELFHEAL_SMOKE", True)
    monkeypatch.setattr(smoke, "SELFHEAL_MAX_BATCH", 8)
    monkeypatch.setattr(smoke, "SELFHEAL_REQUESTS", 96)
    monkeypatch.setattr(smoke, "SELFHEAL_RELOAD_EVERY", 24)
    monkeypatch.setattr(smoke, "SELFHEAL_DIR", tmp_path / "selfheal")
    rec = smoke.selfheal_phase(torch.device("cpu"))
    assert len(rec["reload"]["reloads"]) == 3 and rec["checkpoint"]["leaves"] == 12
    # 12b sized to the host: an interval between reloads lasts 3 probe reloads
    r = rec["reload"]
    assert r["probe_ms"] > 0 and r["reload_every"] >= 24 and r["requests"] == 4 * r["reload_every"]
    assert r["reload_every"] / r["offered_requests_per_s"] >= 3 * r["probe_ms"] / 1e3
    assert rec["checkpoint"]["reference_rel_l2"] <= 1e-3
    assert rec["restart"]["kill"]["requeued_samples"] >= 1
    assert rec["restart"]["kill"]["failed"] == 0 and rec["restart"]["in-dispatch"]["failed"]
    assert "crash loop" in rec["restart"]["loop"]["reason"]
    assert rec["demotion"]["bucket"] == 8 and rec["demotion"]["served_equal"] >= 2
    assert not (tmp_path / "selfheal").exists()


def test_tuning_phase_is_in_the_phase_list(smoke):
    """Phase 13 (tuning) is listed and timed, and runs inside the run's
    temporary autotune cache."""
    import inspect

    assert " 13. tuning" in smoke.__doc__ and " 18. one JSON line" in smoke.__doc__
    assert 'phase_done("13 tuning")' in inspect.getsource(smoke.run)
    assert "temporary_tune_cache()" in inspect.getsource(smoke.main)


def test_temporary_tune_cache_names_a_fresh_file_and_removes_it(smoke, monkeypatch):
    import os

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "/nowhere/kept.json")
    with smoke.temporary_tune_cache() as path:
        assert os.environ["REPRO_AUTOTUNE_CACHE"] == str(path)
        assert path.parent.is_dir() and not path.exists()
        path.write_text("{}")
    assert not path.parent.exists()
    assert os.environ["REPRO_AUTOTUNE_CACHE"] == "/nowhere/kept.json"


def test_searched_holds_every_tuned_time_to_its_default(smoke, tmp_path):
    import json

    path = tmp_path / "autotune.json"
    entry = {"tiles": {"tile_rows": 64}, "default_tiles": {"tile_rows": 128},
             "measured_us": 50.0, "default_us": 60.0, "modeled_best_us": 1.0,
             "modeled_default_us": 1.0, "n_candidates": 2}
    key = "cuda|matmul_tc|4x512x72x8x3xint8"
    path.write_text(json.dumps({"version": 1, "calibration": {}, "entries": {
        key: entry, "cpu|matmul_tc|4x512x72x8x3xint8": {"tiles": {"bm": 8}}}}))
    got = smoke.searched(path)
    assert list(got) == [key] and got[key]["speedup"] == 60.0 / 50.0
    path.write_text(json.dumps({"version": 1, "calibration": {}, "entries": {
        key: dict(entry, measured_us=61.0)}}))
    with pytest.raises(AssertionError, match="above the default"):
        smoke.searched(path)


def test_rebuild_from_cache_refuses_a_search_or_other_choices(smoke):
    from types import SimpleNamespace

    from repro_torch.kernels import autotune

    built = SimpleNamespace(tiles={1: {"l1": {"tile_rows": 64}}})
    assert smoke.rebuild_from_cache(lambda: built, built.tiles, "t") is built
    with pytest.raises(AssertionError, match="other choices"):
        smoke.rebuild_from_cache(lambda: built, {1: {}}, "t")

    def searching():
        autotune._SEARCHES[0] += 1
        return built

    with pytest.raises(AssertionError, match="1 searches"):
        smoke.rebuild_from_cache(searching, built.tiles, "t")


def test_tuning_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """Phase 13 end to end on the CPU at the smoke configs (buckets 1 … 4):
    the calibration's defaults (nothing is measured on the CPU), both
    patterns' searched sets equal to 'off' and their 'cache' rebuilds
    search-free, the LM's generate in turns with graph = eager, the INT8
    plan searched equal to 'off'; the registry left empty."""
    import torch

    from repro_torch.kernels import core

    _rehearse(smoke, monkeypatch)
    monkeypatch.setattr(smoke, "TUNE_SMOKE", True)
    monkeypatch.setattr(smoke, "TUNE_BUCKETS", (1, 2, 4))
    with smoke.temporary_tune_cache() as path:
        rec = smoke.tuning_phase(torch.device("cpu"), {"prefill_ms": 1.0, "ms_per_step": 1.0})
        assert not path.exists()
    assert rec["calibration"]["source"] == "default" and rec["searched"] == {}
    assert all(r["searches"] == 0 and r["changed"] == {} for r in rec["cnn"].values())
    lm = rec["lm"]
    assert lm["bf16_searches"] == lm["int8_searches"] == 0
    assert set(lm["generate"]) == {"untuned", "tuned"}
    assert len(lm["generate"]["tuned"]["ms_per_step"]) == 2
    assert core.tuned_entries() == {}


def test_training_phase_is_in_the_phase_list(smoke):
    """Phase 14 (training and accounting) is listed and timed after tuning,
    and its launches reach the kernels' line."""
    import inspect

    assert " 14. training and accounting" in smoke.__doc__
    src = inspect.getsource(smoke.run)
    assert src.index('phase_done("13 tuning")') < src.index('phase_done("14 training and accounting")')
    assert "training)" in src[src.index("kernels_line("):]


def test_training_phase_rehearses_on_the_cpu(smoke, monkeypatch, tmp_path):
    """Phase 14 end to end on the CPU at the smoke configs: 14a's parity
    (the CPU standing in for the card), the kill-resume twin and the
    compressed-gradient steps; 14b's Trainer on starcoder2-7b's smoke
    config (12 steps, the gates); 14c's gated products on the trained
    model's layer-0 activations and sparse-cnn-s's accounting (batch 4).
    The CUDA memory calls are stubbed; the plain versions count no
    launches."""
    import torch

    for name in ("empty_cache", "reset_peak_memory_stats", "max_memory_allocated", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    monkeypatch.setattr(smoke, "TRAIN_SMOKE", True)
    monkeypatch.setattr(smoke, "TRAIN_DIR", tmp_path / "train")
    rec = smoke.train_phase(torch.device("cpu"))
    par = rec["parity"]
    assert par["loss_rel_err"] == 0.0 and par["steps"]["worst_ratio"] == 0.0
    assert par["resume_max_abs_diff"] == 0.0 and len(par["ef_losses"]) == smoke.PARITY_STEPS
    train = rec["train"]
    assert len(train["losses"]) == smoke.TRAIN_STEPS and train["losses"][-1] < train["losses"][0]
    assert 0 < train["optimizer_share"] < 1 and 0 < train["constrain_share"] < 1
    assert train["tokens_per_s"] == 16 * 2 / (train["ms_per_step"] / 1e3)
    assert train["params"] == train["state_bytes_reckoned"] // smoke.BYTES_PER_PARAM
    assert set(rec["sparse_matmul"]) == {"wq/wo", "wk/wv", "w_up", "w_down"}
    for r in rec["sparse_matmul"].values():
        assert r["measured"]["err"] == 0.0 and r["assumed_0.5"]["act_fmt"] == "4/8"
    for r in rec["cnn"].values():
        assert r["zero_frac_max_diff"] == 0.0 and r["measured_tops_per_w"] > 0
        assert r["logits_max_abs_diff"] == 0.0 and r["logits_rel_l2"] == 0.0
        assert r["assumed_tops_per_w"] > 0
    assert not (tmp_path / "train").exists()


def test_train_parity_holds_noise_entries_to_the_learning_rate(smoke):
    """``trees_close`` passes a noise entry beyond the tolerance that moved,
    in both runs, within AdamW's reach at the learning rates (one update at
    1e-3 from 0.5: 1e-3 · (1 + 0.1 · 0.501)), and fails one that moved
    further, any other entry beyond the tolerance, or an entry zero on one
    side only."""
    import torch

    from repro_torch.optim.adamw import OptConfig

    opt = OptConfig()
    start = {"w": torch.tensor([1.0, 0.5, 0.0])}
    want = {"w": torch.tensor([1.0, 0.5 + 9e-4, 0.0])}
    noise = [torch.tensor([False, True, False])]
    kw = dict(noise=noise, start=start, lrs=[1e-3], opt=opt)
    got = {"w": torch.tensor([1.0, 0.5 - 9e-4, 0.0])}
    assert smoke.trees_close(got, want, "t", **kw)["held_to_reach"] == 1
    with pytest.raises(AssertionError, match="reach"):
        smoke.trees_close({"w": torch.tensor([1.0, 0.5 - 1.2e-3, 0.0])}, want, "t", **kw)
    with pytest.raises(AssertionError, match="worst ratio"):
        smoke.trees_close({"w": torch.tensor([1.001, 0.5 + 9e-4, 0.0])}, want, "t", **kw)
    with pytest.raises(AssertionError, match="zero on one side"):
        smoke.trees_close({"w": torch.tensor([1.0, 0.5, 1e-9])}, start, "t")


def test_model_flops_counts_the_products_and_the_attention(smoke):
    from repro_torch.models.model import lm_defs

    cfg = smoke.train_config()  # starcoder2-7b at published width, 8 layers
    assert abs(cfg.param_count() - 2.19e9) < 0.01e9
    tokens, seq = 2048, 256
    embed = 49152 * 4608
    assert lm_defs(cfg)["embed"].shape == (49152, 4608)
    want = 6 * (cfg.param_count() - embed) * tokens + 12 * 8 * seq * 36 * 128 * tokens
    assert smoke.model_flops(cfg, tokens, seq) == want


def test_dist_phase_is_in_the_phase_list(smoke):
    """Phase 15 (distribution on a one-rank mesh) is listed and timed after
    training, and its sharded launches reach the kernels' line."""
    import inspect

    assert " 15. distribution on a one-rank" in smoke.__doc__
    src = inspect.getsource(smoke.run)
    assert src.index('phase_done("14 training and accounting")') < \
        src.index('phase_done("15 distribution on a one-rank mesh")')
    assert "distributed)" in src[src.index("kernels_line("):]


def test_dist_phase_rehearses_on_the_cpu(smoke, monkeypatch, tmp_path):
    """Phase 15 on the CPU at the smoke configs, on a one-rank gloo world:
    15a's 8 sharded decode steps (batch 2, a 16-token prompt) equal to the
    unsharded ones bit for bit (and its ops counted, DTensor ops on the
    sharded side only), 15b's sharded ``Trainer`` and its optimizer state
    equal to the unsharded ones bit for bit, 15c's restore equal to what
    was saved. The
    plain versions count no launches; the CUDA memory calls are stubbed."""
    import torch
    import torch.distributed as dist

    for name in ("empty_cache", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    monkeypatch.setattr(smoke, "DIST_SMOKE", True)
    monkeypatch.setattr(smoke, "DIST_DIR", tmp_path / "dist")
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    rec = smoke.dist_phase(torch.device("cpu"))
    assert not dist.is_initialized()  # the world is torn down
    d = rec["decode"]
    assert d["bit_equal_steps"] == smoke.DIST_STEPS and d["max_abs_diff"] == 0.0
    assert d["launches"] == {"unsharded": 0, "sharded": 0, "want": 0}
    ops = d["ops_per_step"]
    assert ops["unsharded"]["dtensor_ops"] == 0 < ops["unsharded"]["ops"]
    assert 0 < ops["sharded"]["dtensor_ops"] <= ops["sharded"]["ops"]
    t = rec["train"]
    assert t["bit_equal"] and t["max_param_diff"] == 0.0
    gaps = t["state_gaps"]  # one rank on the CPU: the same state bit for bit
    assert gaps["count"] == [smoke.DIST_TRAIN_STEPS] * 2
    assert gaps["m"][0] == gaps["v"][0] == gaps["update"] == 0.0
    assert len(t["losses"]["sharded"]) == smoke.DIST_TRAIN_STEPS
    assert t["placements"] == ["(Replicate(), Replicate())"]  # one rank: a shard is the whole
    r = rec["restore"]
    assert r["bit_equal"] and r["placements_equal"] and r["step"] == smoke.DIST_TRAIN_STEPS
    assert not (tmp_path / "dist" / "ckpt").exists()


def test_mesh_phase_is_in_the_phase_list(smoke):
    """Phase 16 (mesh serving, the dry run, the context decode) is listed
    and timed after phase 15, and its launches reach the kernels line."""
    import inspect

    assert " 16. the mesh (phase 16)" in smoke.__doc__
    src = inspect.getsource(smoke.run)
    assert src.index('phase_done("15 distribution on a one-rank mesh")') < \
        src.index('phase_done("16 mesh serving, the dry run and the context decode")')
    assert "meshed)" in src[src.index("kernels_line("):]


def test_family_phase_is_in_the_phase_list(smoke):
    """Phase 17 (the families on the one-rank mesh) is listed and timed
    after phase 16, and its launches reach the kernels line."""
    import inspect

    assert " 17. the families on the one-rank mesh" in smoke.__doc__
    src = inspect.getsource(smoke.run)
    assert src.index('phase_done("16 mesh serving, the dry run and the context decode")') < \
        src.index('phase_done("17 the families on a one-rank mesh")')
    assert "families)" in src and "family_launches" in inspect.getsource(smoke.kernels_line)


def test_family_phase_rehearses_on_the_cpu(smoke, monkeypatch, tmp_path):
    """Phase 17 on the CPU at the smoke configs (batch 2, a 16-token prompt,
    recurrentgemma's 32-token window), on a one-rank gloo world: 17a's
    prefill and 8 decode steps of each family equal to the unsharded ones
    bit for bit, the ring wrapping; 17b's sharded ``Trainer`` of the audio
    model equal to the unsharded one bit for bit, the MoE's (fp32) within
    1e-5 (measured 4.9e-7: on one rank autograd sums the rows' gradients in
    another order around the dispatch's ``local_map``); 17c's five
    production cells in their own processes, each ``ok`` (the dry run
    allocates nothing, so the cells are the card's). The plain versions
    count no launches; the CUDA memory calls are stubbed."""
    import torch
    import torch.distributed as dist

    for name in ("empty_cache", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    monkeypatch.setattr(smoke, "DIST_SMOKE", True)
    monkeypatch.setattr(smoke, "DIST_DIR", tmp_path / "dist")
    monkeypatch.setattr(smoke, "FAMILY_DIR", tmp_path / "dryrun")
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    rec = smoke.family_phase(torch.device("cpu"))
    assert not dist.is_initialized()
    assert list(rec["decode"]) == list(smoke.FAMILY_ARCHS)
    modes = {a: r["attn_mode"] for a, r in rec["decode"].items()}
    # the smoke configs' heads at tp 16: 4 heads, none divides it (rwkv6: feature)
    assert modes == {"moonshot-v1-16b-a3b": "context", "deepseek-v3-671b": "context",
                     "rwkv6-3b": "feature", "recurrentgemma-2b": "context",
                     "musicgen-medium": "context"}
    for arch, r in rec["decode"].items():
        assert r["prefill_bit_equal"] and r["bit_equal_steps"] == smoke.DIST_STEPS, (arch, r)
        assert r["launches"]["decode"] == {"unsharded": 0, "sharded": 0}
    ring = rec["decode"]["recurrentgemma-2b"]
    assert ring["prompt"] == ring["cache"] == 32  # the ring is full: the first step wraps it
    for arch, t in rec["train"].items():
        if t["dtype"] == "torch.float32":  # the MoE: its rows' gradients summed in another order
            assert t["max_param_diff"] <= 1e-5 and t["state_gaps"]["update"] <= 1e-4, (arch, t)
            continue
        assert t["bit_equal"] and t["max_param_diff"] == 0.0, (arch, t)
        assert t["state_gaps"]["m"][0] == t["state_gaps"]["update"] == 0.0
    cells = {k: r for k, r in rec["dryrun"].items() if k != "wall_s"}
    assert len(cells) == 5 and sum("pod2" in k for k in cells) == 2
    for key, r in cells.items():
        assert r["cost"]["flops"] > 0 and sum(r["collectives"]["counts"].values()) > 0
        assert all(c["local"] == c["spec"] for c in r["memory"]["argument_bytes_checked"])


def test_mesh_phase_rehearses_on_the_cpu(smoke, monkeypatch, tmp_path):
    """Phase 16 on the CPU: 16a at sparse-cnn-s's smoke config (buckets
    2 … 8, 32 requests a run, two runs each way in turns) with every
    request and the ragged 5 equal to the one-device plan set bit for bit;
    16b's four production cells in their own processes, each ``ok`` (the
    dry run allocates nothing, so the cells are the card's); 16c's context
    decode on a one-rank gloo world at the smoke config, bit for bit. The
    CUDA synchronize and memory calls are stubbed; the plain versions count
    no launches."""
    import torch
    import torch.distributed as dist

    for name in ("empty_cache", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    monkeypatch.setattr(smoke, "MESH_SMOKE", True)
    monkeypatch.setattr(smoke, "MESH_MAX_BATCH", 8)
    monkeypatch.setattr(smoke, "SERVER_REQUESTS", 32)
    monkeypatch.setattr(smoke, "DRYRUN_DIR", tmp_path / "dryrun")
    monkeypatch.setattr(smoke, "DIST_SMOKE", True)
    monkeypatch.setattr(smoke, "DIST_DIR", tmp_path / "dist")
    monkeypatch.setattr(smoke, "LM_BATCH", 2)
    monkeypatch.setattr(smoke, "LM_PROMPT", 16)
    rec = smoke.mesh_phase(torch.device("cpu"))
    assert not dist.is_initialized()
    s = rec["serve"]
    assert s["buckets"] == [2, 4, 8] and s["ragged_equal"]
    assert s["bit_equal_requests"] == {"one_device": 64, "mesh": 64}  # two runs each, in turns
    assert s["launches"] == {"im2col_conv": 0, "vdbb_conv_tc": 0, "vdbb_matmul_tc": 0}
    assert {k: len(v) for k, v in s["summary"].items()} == {"one_device": 2, "mesh": 2}
    cells = {k: r for k, r in rec["dryrun"].items() if k != "wall_s"}
    assert len(cells) == 4 and sum("pod2" in k for k in cells) == 1
    for key, r in cells.items():
        assert r["attn_mode"] == ("context" if "starcoder2" in key else "q_sharded")
        assert r["cost"]["flops"] > 0 and sum(r["collectives"]["counts"].values()) > 0
        assert all(c["local"] == c["spec"] for c in r["memory"]["argument_bytes_checked"])
    c = rec["context_decode"]
    assert c["attn_mode"] == "context" and c["bit_equal_steps"] == smoke.DIST_STEPS
    assert c["max_abs_diff"] == 0.0 and c["context_decodes"] > 0
