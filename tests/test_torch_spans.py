"""repro_torch's phase spans (``repro_torch/spans.py``) on the CPU: free and
shared while no profiler records, named ``repro_torch.*`` in the trace
while one does; ``generate``'s phases in order, one capture span per graph,
its tokens and kept logits the same with a profiler recording or not; a
CPU ``ModelPlan.serve``, which runs eagerly, with no ``plan.*`` span; and
every reading of the card's kernels or busy time blind to the card's copies
of spans."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from repro_torch import cost_utils
from repro_torch.kernels import timing
from repro_torch.launch import serve
from repro_torch.models.plan import LayerPlan, ModelPlan
from repro_torch.spans import PREFIX, is_span, span

ROOT = Path(__file__).resolve().parents[1]

GENERATE = ["generate.capture", "generate.timing_prefill", "generate.prefill",
            "generate.capture", "generate.reset", "generate.decode", "generate.release"]


def _program_spans(prof) -> list:
    """The ``repro_torch.*`` host events of a profile, by start."""
    evs = [(e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
           if e.name().startswith(PREFIX)]
    return [n[len(PREFIX):] for _, n in sorted(evs)]


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_one_shared_null_span_and_no_event():
    off = span("a")
    assert off is span("b")
    with _recording() as prof:
        with off:
            torch.ones(2).sum()
        with span("on"):
            torch.ones(2).sum()
    assert _program_spans(prof) == ["on"]


def _tiny_generate(gen_len, recording):
    model = serve.build_lm("qwen2-tiny", device="cpu")
    prompt = serve.prompt_tokens(model, batch=2, seq=8)
    kw = dict(gen_len=gen_len, max_len=8 + gen_len, keep=(0, gen_len - 2), prefill_reps=2)
    if not recording:
        return serve.generate(model, prompt, **kw), None
    with _recording() as prof:
        rec = serve.generate(model, prompt, **kw)
    return rec, prof


def test_generate_emits_its_phases_in_order_and_serves_the_same():
    rec, prof = _tiny_generate(5, True)
    assert _program_spans(prof) == GENERATE  # one capture a graph, no span a step
    want, _ = _tiny_generate(5, False)
    assert torch.equal(rec["tokens"], want["tokens"])
    assert rec["logits"].keys() == want["logits"].keys() == {0, 3}
    for i in want["logits"]:
        assert torch.equal(rec["logits"][i], want["logits"][i])
    assert rec["forwards"] == want["forwards"] and rec["captures"] == want["captures"] == 2


def test_a_one_token_call_has_no_decode_capture_or_reset():
    rec, prof = _tiny_generate(1, True)
    assert _program_spans(prof) == ["generate.capture", "generate.timing_prefill",
                                    "generate.prefill", "generate.decode", "generate.release"]
    assert rec["tokens"].shape == (2, 1)


def test_a_cpu_plan_serves_eagerly_with_no_plan_span():
    plan = ModelPlan("m", "f", (LayerPlan("double", "pool", (), lambda x: 2 * x),),
                     device="cpu")
    x = torch.arange(6.0).reshape(2, 3)
    with _recording() as prof:
        y = plan.serve(x)
    assert torch.equal(y, 2 * x)
    assert _program_spans(prof) == []
    assert plan.trace_count == 1 and plan.replays == 0


def _event(name, end_us, dev=True, **kw):
    kind = torch.autograd.DeviceType.CUDA if dev else torch.autograd.DeviceType.CPU
    return SimpleNamespace(device_type=kind, name=name,
                           time_range=SimpleNamespace(start=0.0, end=end_us), **kw)


# one kernel of 100 us; the card's copy of a program span as torch 2.11 gives
# it (no flag), a flagged copy of a harness's span, and a host span
EVENTS = [_event("kernel", 100.0), _event(PREFIX + "plan.replay", 400.0),
          _event("portbench.request", 1000.0, is_user_annotation=True),
          _event(PREFIX + "plan.replay", 500.0, dev=False, is_user_annotation=True)]


def test_is_span_tells_annotations_from_work():
    assert [is_span(e) for e in EVENTS] == [False, True, True, True]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("reader", ["device_ms", "op_breakdown", "profile_forwards",
                                    "kernel_names"])
def test_device_readings_leave_out_the_cards_copies_of_spans(monkeypatch, reader):
    """A plan serve's ``plan.replay`` copy spans its replay's first kernel to
    its last: counted, it would fill the gaps between kernels and pass for a
    kernel. Each reader sees the one kernel alone."""
    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return EVENTS

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    if reader == "device_ms":
        assert timing.device_ms(lambda: None) == pytest.approx(0.1)
    elif reader == "op_breakdown":
        got = cost_utils.op_breakdown(lambda: None, profile=True)
        assert got["kernels"] == {"kernel": 1} and got["n_kernels"] == 1
    elif reader == "profile_forwards":
        got = _chip_smoke().profile_forwards(lambda x: None, None, {}, reps=1)
        assert got["device_ms"] == pytest.approx(0.1)
        assert got["per_kernel_ms"] == pytest.approx({"other": 0.1})
        assert got["top_other_ms"] == pytest.approx({"kernel": 0.1})
    else:
        assert _chip_smoke().kernel_names(lambda: None) == {"kernel"}
