"""The port's frozen serving plans (``repro_torch/models/plan.py``) on the
CPU, where a plan runs its staged chain eagerly on the plain versions (the
CUDA graphs are held on the card, ``tests/test_torch_cuda.py``).

Ports the intent of the reference's plan tests (``tests/test_serve.py``'s
buckets, ragged serving, host path, zero recapture and staleness;
``TestModelPlan`` in ``tests/test_autotune.py``) at ``sparse-cnn-tiny``'s
smoke size, both pattern modes: planned logits equal the unplanned
forward's exactly (staging moves host work, never arithmetic). Then the
port's plan set against the JAX package's, both in ref mode on the golden
fixtures' parameters, at ragged batches: within the fixtures' 1e-3
relative L2 (the fp32 stem sums in another order on each side, so a stem
code may differ by one).
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from repro.models.cnn import SparseCNN as JSparseCNN
from repro_torch.configs import smoke_cnn_config
from repro_torch.interop import params_from_numpy, unflatten
from repro_torch.launch import serve
from repro_torch.models.cnn import SparseCNN
from repro_torch.models.plan import (ModelPlan, PlanSet, StalePlanError, make_buckets,
                                     params_fingerprint, resolve_tune_cache)

PATTERNS = ["matrix", None]


def _model(pattern="matrix", seed=0):
    return serve.build_model("sparse-cnn-tiny", calib_batch=4, device="cpu", smoke=True,
                             pattern=pattern, seed=seed)


@pytest.fixture(scope="module", params=PATTERNS, ids=["tc", "bw"])
def served(request):
    """A calibrated int8 chain, 12 seeded images and a max_batch=8 plan set."""
    model, _ = _model(request.param)
    x = np.random.default_rng(1).normal(size=(12, 16, 16, 3)).astype(np.float32)
    return model, x, model.plan_set(max_batch=8)


def _forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(np.ascontiguousarray(x)))


# ------------------------------------------------------------ buckets


def test_make_buckets_ladder():
    assert make_buckets(8) == (1, 2, 4, 8)
    assert make_buckets(1) == (1,)
    assert make_buckets(5) == (1, 2, 4, 8)  # the first bucket >= max_batch
    assert make_buckets(64) == (1, 2, 4, 8, 16, 32, 64)
    with pytest.raises(ValueError):
        make_buckets(0)


def test_bucket_for(served):
    _, _, ps = served
    assert ps.buckets == (1, 2, 4, 8)
    assert [ps.bucket_for(n) for n in (1, 3, 8, 9)] == [1, 4, 8, None]


def test_plan_set_validates(served):
    model, _, ps = served
    with pytest.raises(ValueError):
        PlanSet(ps.model, ps.fingerprint, (4, 2), dict(ps.plans))
    with pytest.raises(ValueError):
        PlanSet(ps.model, ps.fingerprint, (1, 2), dict(ps.plans))
    with pytest.raises(ValueError):
        model.plan_set(buckets=(0, 2))
    with pytest.raises(ValueError):
        model.plan_set()  # needs max_batch or buckets
    assert model.plan_set(buckets=(3, 1, 3)).buckets == (1, 3)


# --------------------------------------------- planned equals unplanned


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 11])
def test_ragged_serve_matches_per_request_and_forward(served, n):
    """Padding to the bucket and slicing back equals serving each request
    alone and the unplanned forward (n = 11 > the largest bucket chunks)."""
    model, x, ps = served
    got = ps.serve(torch.from_numpy(x[:n]))
    per = torch.cat([ps.plans[1].serve(torch.from_numpy(x[i: i + 1])) for i in range(n)])
    assert torch.equal(got, per)
    assert torch.equal(got, _forward(model, x[:n]))


def test_host_path_matches_tensor_path(served):
    """numpy in (the serving tier's host-assembly path) gives numpy out,
    equal to the tensor path."""
    _, x, ps = served
    host = ps.serve(x[:5])
    assert isinstance(host, np.ndarray) and host.dtype == np.float32
    np.testing.assert_array_equal(host, ps.serve(torch.from_numpy(x[:5])).numpy())


def test_serve_hooks(served):
    """``on_dispatch`` sees each bucket dispatch, ``dispatch`` replaces it
    and ``put`` maps each padded chunk (the host path's default:
    ``torch.from_numpy``)."""
    _, x, ps = served
    seen, chunks = [], []

    def put(xb):
        chunks.append(xb.shape)
        return torch.from_numpy(xb)

    got = ps.serve(x[:11], put=put, on_dispatch=lambda b, n: seen.append((b, n)),
                   dispatch=lambda b, xb: ps.plans[b].serve(xb) + b)
    assert seen == [(8, 8), (4, 3)] and chunks == [(8, 16, 16, 3), (4, 16, 16, 3)]
    want = ps.serve(x[:11])
    np.testing.assert_array_equal(got, np.concatenate([want[:8] + 8, want[8:] + 4]))


def test_serve_rejects_empty(served):
    _, x, ps = served
    with pytest.raises(ValueError):
        ps.serve(x[:0])


def test_plan_checked_forward_and_refusals(served):
    """``forward(x, plan=)`` checks the pin and serves; a plan refuses the
    calibration and intermediate outputs of the unplanned forward."""
    model, x, ps = served
    xt = torch.from_numpy(x[:4])
    plan = ps.plans[4]
    assert torch.equal(model(xt, plan=plan), _forward(model, x[:4]))
    assert torch.equal(model(xt, plan=ps), _forward(model, x[:4]))
    with pytest.raises(ValueError, match="frozen hot path"):
        model(xt, plan=plan, collect_act_stats=True)
    with pytest.raises(ValueError, match="frozen hot path"):
        model(xt, plan=plan, intermediates=[])


def test_plan_stages_and_tiles(served):
    """The stages are the reference's (each conv, gap, the head); the int8
    layers record their tile plan, the stem its path."""
    model, _, ps = served
    plan = ps.plans[8]
    n = len(model.layers())
    assert [l.name for l in plan.layers] == [f"l{i}" for i in range(n - 1)] + ["gap", f"l{n - 1}"]
    assert [l.kind for l in plan.layers] == ["conv"] * (n - 1) + ["pool", "linear"]
    assert plan.tiles["l0"] == {"path": "direct"}
    gathered = model.cfg.fmt.group == "matrix"
    for i in range(1, n):
        t = plan.tiles[f"l{i}"]
        assert t["gathered"] is gathered and t["tile_rows"] in (64, 128)
    assert plan.sample_spec == ((16, 16, 3), "float32") == ps.sample_spec
    assert plan.batch == 8 and set(ps.tiles) == set(ps.buckets)


def test_eager_plan_stages_the_same_kernels(served):
    """``graphs=False`` (a serving fallback's staging) stages the same chain
    with the same tile plans, serves what the graphed plan serves, and
    holds no graph pool; a plan set of such plans shares none either."""
    model, x, ps = served
    eager = model.plan(batch=8, graphs=False)
    assert not eager.graphs and ps.plans[8].graphs
    assert eager.tiles == ps.plans[8].tiles and eager.pool is None
    xt = torch.from_numpy(x[:8])
    assert torch.equal(eager.serve(xt), ps.plans[8].serve(xt))
    assert eager.trace_count == 1 and eager.replays == 0
    eager_set = model.plan_set(buckets=ps.buckets, graphs=False)
    assert all(not p.graphs and p.pool is None for p in eager_set.plans.values())


def test_fp_chain_plan_matches_forward():
    """A plan also stages the per-layer chain of a compressed, unquantized
    model (no tiles), equal to its forward."""
    cfg = smoke_cnn_config("sparse-cnn-tiny")
    model = SparseCNN(cfg).init(torch.Generator().manual_seed(0), "cpu").compress()
    x = np.random.default_rng(2).normal(size=(3, 16, 16, 3)).astype(np.float32)
    plan = model.plan(batch=3)
    assert plan.tiles == {}
    assert torch.equal(plan.serve(torch.from_numpy(x)), _forward(model, x))


def test_linear_make_plan_requantizes_at_out_scale_unfused():
    """The per-layer branch of ``make_plan`` applies ReLU and requantizes
    at ``out_scale``, as the conv twin does."""
    model, x = _model()
    head = model.layers()[-1]
    pooled = torch.randn(5, head.in_features, generator=torch.Generator().manual_seed(3))
    run, tiles = head.make_plan(batch=5, relu=True, out_scale=torch.tensor(0.07))
    assert tiles == {}
    with torch.no_grad():
        want = torch.relu(head(pooled))
    got = run(pooled)
    assert got.dtype == torch.int8
    assert torch.equal(got, torch.round(want / 0.07).clamp(-127, 127).to(torch.int8))


def test_head_plan_needs_a_calibrated_scale():
    model, _ = _model()
    head = model.layers()[-1]
    head.put("aq", None)
    with pytest.raises(ValueError, match="calibrat"):
        head.make_plan(batch=2, fused=True)


# ----------------------------------------------- zero recapture, staleness


def test_no_recapture_after_warmup(served):
    _, x, ps = served
    base = ps.warmup()
    assert base >= len(ps.buckets)
    for n in (1, 2, 3, 5, 8, 11):  # every ragged size pads to a warm bucket
        ps.serve(x[:n])
        ps.serve(torch.from_numpy(x[:n]))
    assert ps.trace_count == base


def test_trace_count_counts_new_shapes(served):
    _, x, ps = served
    ps.warmup()
    plan = ps.plans[2]
    before = plan.trace_count
    plan.serve(torch.from_numpy(x[:2]))  # warm: nothing new
    assert plan.trace_count == before
    plan.serve(torch.from_numpy(x[:3]))  # off-bucket direct use: a new signature
    assert plan.trace_count == before + 1


def test_stale_after_requantize_and_frozen_tensors():
    """A re-quantize in place moves the fingerprint: the checked forms raise
    StalePlanError, while the plan still serves the tensors it froze."""
    model, xcal = _model()
    x = np.random.default_rng(4).normal(size=(4, 16, 16, 3)).astype(np.float32)
    ps = model.plan_set(max_batch=4)
    plan = ps.plans[4]
    before = _forward(model, x)
    ps.check(model.state())
    plan.check(model.state())
    with torch.no_grad():
        _, stats = model(xcal * 2.0, collect_act_stats=True)
    model.quantize(stats)
    for checked in (ps, plan):
        with pytest.raises(StalePlanError):
            checked.check(model.state())
        with pytest.raises(StalePlanError):
            model(torch.from_numpy(x), plan=checked)
    assert not torch.equal(_forward(model, x), before)
    assert torch.equal(plan.serve(torch.from_numpy(x)), before)


def test_fingerprint_tracks_content():
    model, _ = _model()
    state = model.state()
    fp = params_fingerprint(state)
    assert params_fingerprint(model.state()) == fp  # the same content
    assert params_fingerprint(_model()[0].state()) == fp  # rebuilt from the same seed
    head = model.layers()[-1]
    head.w.values.view(-1)[0] += 1  # one byte of one leaf
    assert params_fingerprint(model.state()) != fp
    head.w.values.view(-1)[0] -= 1
    assert params_fingerprint(model.state()) == fp
    head.put("aq", head.aq * 2)
    assert params_fingerprint(model.state()) != fp


def test_plan_is_immutable(served):
    _, _, ps = served
    plan = ps.plans[1]
    with pytest.raises(dataclasses.FrozenInstanceError):
        plan.fingerprint = "tampered"
    with pytest.raises(dataclasses.FrozenInstanceError):
        plan.layers[0].tiles = ()
    with pytest.raises(TypeError):
        ps.plans[1] = plan
    assert isinstance(plan, ModelPlan)


@pytest.mark.parametrize("tune", ["cache", "search"])
def test_only_tune_off(tune):
    """On the CPU only the rules' launch choices exist: the plain versions
    take none, so 'cache' and 'search' resolve to what 'off' stages (nothing
    read, measured or installed) and serve its logits bit for bit; an
    unknown mode raises."""
    from repro_torch.kernels import core

    model, _ = _model()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 16, 16, 3)).astype(np.float32))
    assert resolve_tune_cache(tune, "c", "cpu") == "c"
    off, tuned = model.plan(batch=3, tune="off"), model.plan(batch=3, tune=tune)
    assert tuned.tiles == off.tiles
    assert torch.equal(tuned(x), off(x))
    set_off, set_tuned = model.plan_set(max_batch=2, tune="off"), model.plan_set(max_batch=2,
                                                                                  tune=tune)
    assert set_tuned.tiles == set_off.tiles
    assert torch.equal(set_tuned.serve(x), set_off.serve(x))
    assert core._TUNED == {}
    with pytest.raises(ValueError, match="tune"):
        resolve_tune_cache("fast")
    with pytest.raises(ValueError, match="tune"):
        model.plan(batch=1, tune="fast")
    assert resolve_tune_cache("off", "c") == "c"


# ------------------------------------------------------ against the JAX package


@pytest.mark.parametrize("pattern,fixture", [("matrix", tp.FIXTURE), (None, tp.FIXTURE_BW)],
                         ids=["tc", "bw"])
def test_plan_set_matches_jax_plan_set(pattern, fixture):
    """Both packages' plan sets (buckets 1, 2, 4; ref mode) on the fixture's
    parameters, the same seeded images at ragged n = 3 and 5 (5 chunks
    into 4 + 1): within 1e-3 relative L2, the fixtures' tolerance."""
    with np.load(fixture) as z:
        tree = unflatten(z)
    jmodel = JSparseCNN(dataclasses.replace(tp.chain_config(pattern), kernel_mode="ref"))
    jset = jmodel.plan_set(tp.from_numpy(tree["params"]), buckets=(1, 2, 4), tune="off")
    cfg = dataclasses.replace(smoke_cnn_config("sparse-cnn-tiny", pattern=pattern),
                              convs_per_stage=2)
    tset = SparseCNN(cfg).load_state(params_from_numpy(tree["params"], "cpu")).plan_set(
        buckets=(1, 2, 4))
    x = np.random.default_rng(5).normal(size=(5, 16, 16, 3)).astype(np.float32)
    for n in (3, 5):
        want = np.asarray(jset.serve(x[:n]), np.float64)
        got = tset.serve(x[:n]).astype(np.float64)
        assert got.shape == want.shape == (n, 10)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3
