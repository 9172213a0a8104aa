"""The plain references against ``repro_torch`` on the CPU at small sizes:
whole runs of each cell (set-up, window, comparison) on the kernels' plain
versions, and the references' own pieces against the port's."""
import torch

from portbench.lib import harness, weights
from portbench.tests.helpers import SMALL, small_run

LM = dict(harness.resolve("starcoder2-7b.decode-b16").config, **SMALL["starcoder2-7b"])


def test_decode_cell_agrees_with_the_float32_reference():
    out = small_run("starcoder2-7b.decode-b16")
    assert out["correct"]
    # bf16 through two small layers: a served token lies at most a few
    # hundredths below the float32 reference's best
    assert out["checks"]["token_gap"]["value"] < 0.1
    assert out["checks"]["kept_logit_err"]["value"] < 0.1


def test_prefill_cell_agrees_with_the_int8_reference():
    out = small_run("starcoder2-7b.prefill-int8")
    assert out["correct"]
    # bf16 activations and a bf16 calibration pass against float32 ones
    assert out["checks"]["logit_err"]["value"] < 0.2


def test_weights_hold_the_density_bound_and_repeat():
    a = weights.lm_layer(LM, 2**40 + 3, 1, "cpu")
    for name in weights.lm_layout(LM):
        rows = (a[name] != 0).any(dim=1).reshape(-1, 8)
        assert (rows.sum(dim=1) == 3).all(), name
    b = weights.lm_layer(LM, 2**40 + 3, 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], weights.lm_layer(LM, 2**40 + 4, 1, "cpu")["wq"])


def test_lm_reference_fp32_matches_the_port_in_fp32():
    """The reference's float32 forward against the port's LM run in float32
    on the same dense weights."""
    from portbench.lib import program

    cfg = dict(LM, param_dtype="float32", compute_dtype="float32")
    model = program.build_lm(cfg, 9, "cpu")
    tokens = weights.lm_tokens(cfg, 9, "t", 2, 12, "cpu")
    with torch.no_grad():
        got = model.forward(tokens)[..., :cfg["vocab_size"]].float()
    ref = harness.resolve("starcoder2-7b.decode-b16").reference
    want = ref.forward(cfg, 9, tokens)[..., :cfg["vocab_size"]]
    # the reference draws bf16 weights; the port holds them in float32
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
