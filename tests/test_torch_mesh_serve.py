"""Data-parallel CNN serving on a local mesh (``CNNServer(mesh=)``,
``models/plan.py:shard_plan_set``, ``launch/mesh.py:make_local_mesh``) on
the CPU, the twin of the reference's
``tests/test_serve.py::test_mesh_data_parallel_serve_matches_single_device``.

One controller serves over the mesh: each coordinate of the data axis holds
a replica of the plan set staged at ``b / dp`` rows for bucket ``b`` with
that bucket's launch choices, a padded bucket is split over the replicas
and the logits are gathered in order. Checks:

  - ``make_buckets(dp=)`` and ``build_plan_set(dp=)`` as the reference's
    docstrings state them, and their refusals;
  - the reference test's scenario (``sparse-cnn-tiny``, ``dp=2``, a 2 x 2
    mesh, 8 single-sample submits and a ragged 5 padded to bucket 8) equal
    bit for bit (``rtol=0``) to single-device serving, both pattern modes,
    with no capture after warmup;
  - the single-device logits of the golden fixtures' parameters against
    the reference's ``SparseCNN.apply`` in ref mode within 1e-3 relative
    L2, the fixtures' tolerance, and the mesh's equal to them;
  - a fault planted in one replica, raised from the bucket's one dispatch:
    bisection fails the poisoned request alone.
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
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.server import CNNServer
from repro_torch.models.cnn import SparseCNN
from repro_torch.models.plan import (ShardedPlan, build_plan_set, frozen_choices, make_buckets,
                                     shard_plan_set)

WAIT_S = 60
PATTERNS = ["matrix", None]


def _served(pattern):
    model, _ = serve.build_model("sparse-cnn-tiny", calib_batch=4, device="cpu", smoke=True,
                                 pattern=pattern)
    x = np.random.default_rng(1).normal(size=(8, 16, 16, 3)).astype(np.float32)
    return model, x


def test_make_buckets_dp():
    assert make_buckets(8) == (1, 2, 4, 8)
    assert make_buckets(6, dp=2) == (2, 4, 8)
    assert make_buckets(1, dp=4) == (4,)
    assert make_buckets(9, dp=4) == (4, 8, 16)
    with pytest.raises(ValueError, match="dp must be >= 1"):
        make_buckets(8, dp=0)
    with pytest.raises(ValueError, match="max_batch must be >= 1"):
        make_buckets(0, dp=2)


def test_build_plan_set_dp():
    model, _ = _served("matrix")
    ps = model.plan_set(max_batch=6, dp=2)
    assert ps.buckets == (2, 4, 8)
    assert {b: p.batch for b, p in ps.plans.items()} == {2: 2, 4: 4, 8: 8}
    with pytest.raises(ValueError, match=r"buckets \[3\] not positive multiples of dp=2"):
        model.plan_set(buckets=(2, 3, 4), dp=2)
    with pytest.raises(ValueError, match="not positive multiples of dp=2"):
        build_plan_set("m", model.state(), lambda b: None, buckets=(0, 2), dp=2)
    with pytest.raises(ValueError, match="dp=2"):  # a ladder the mesh cannot split
        shard_plan_set(model.plan_set(max_batch=4), ["cpu", "cpu"])
    bare = build_plan_set("m", model.state(), ps.plans.__getitem__, buckets=(2, 4))
    with pytest.raises(ValueError, match="cannot restage"):
        shard_plan_set(bare, ["cpu", "cpu"])


def test_local_mesh_devices():
    mesh = make_local_mesh((2, 2), ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.along("data") == [torch.device("cpu")] * 2
    devs = ["cpu:0", "cpu:1", "cpu:2", "cpu:3", "cpu:4", "cpu:5", "cpu:6", "cpu:7"]
    mp = make_local_mesh((2, 2, 2), ("pod", "data", "model"), devs)
    # ('pod', 'data') split pod-major; 'model' held at its index 0
    assert [d.index for d in mp.along(("pod", "data"))] == [0, 2, 4, 6]
    with pytest.raises(ValueError, match="mesh's order"):
        mp.along(("data", "pod"))
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_local_mesh((2, 2), ("data", "model"), ["cpu"] * 3)


@pytest.mark.parametrize("pattern", PATTERNS, ids=["tc", "bw"])
def test_mesh_serve_matches_single_device(pattern):
    """The reference test's scenario: bit for bit, no capture after warmup;
    every replica staged at half its bucket with the bucket's choices."""
    model, x = _served(pattern)
    ps = model.plan_set(max_batch=8, dp=2)
    assert ps.buckets == (2, 4, 8)
    single = ps.serve(x)
    srv = CNNServer(ps, max_wait_ms=50.0, mesh=make_local_mesh((2, 2), ("data", "model")))
    for b, plan in srv.plan_set.plans.items():
        assert isinstance(plan, ShardedPlan) and len(plan.replicas) == 2
        assert all(r.batch == b // 2 for r in plan.replicas)
        assert all(frozen_choices(r) == frozen_choices(ps.plans[b]) for r in plan.replicas)
    with srv:
        srv.warmup(x.shape[1:])
        futs = [srv.submit(x[i: i + 1]) for i in range(8)]
        out = np.concatenate([f.result(timeout=WAIT_S) for f in futs])
        ragged = srv.serve_batch(x[:5])  # pads 5 -> bucket 8, split 4 + 4
    np.testing.assert_array_equal(out, single)
    np.testing.assert_array_equal(ragged, single[:5])
    assert srv.retraces_after_warmup == 0
    assert srv.stats.summary()["accounting_ok"]


@pytest.mark.parametrize("pattern,fixture", [("matrix", tp.FIXTURE), (None, tp.FIXTURE_BW)],
                         ids=["tc", "bw"])
def test_mesh_serve_against_the_reference(pattern, fixture):
    """The fixture's parameters in both packages: the port's single-device
    plan set within 1e-3 relative L2 of the reference's ``apply`` in ref
    mode at a ragged 5, and the mesh server's logits equal to it bit for
    bit."""
    with np.load(fixture) as z:
        tree = unflatten(z)
    jmodel = JSparseCNN(dataclasses.replace(tp.chain_config(pattern), kernel_mode="ref"))
    x = np.random.default_rng(5).normal(size=(5, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(tp.from_numpy(tree["params"]), x), np.float64)
    cfg = dataclasses.replace(smoke_cnn_config("sparse-cnn-tiny", pattern=pattern),
                              convs_per_stage=2)
    ps = SparseCNN(cfg).load_state(params_from_numpy(tree["params"], "cpu")).plan_set(
        max_batch=8, dp=2)
    single = ps.serve(x)
    assert single.shape == want.shape == (5, 10)
    assert np.linalg.norm(single - want) / np.linalg.norm(want) <= 1e-3
    with CNNServer(ps, max_wait_ms=1.0, mesh=make_local_mesh((2, 2), ("data", "model"))) as srv:
        srv.warmup()
        np.testing.assert_array_equal(srv.serve_batch(x), single)
    assert srv.retraces_after_warmup == 0


def test_replica_fault_fails_the_poisoned_request_alone():
    """A fault planted in replica 1 alone, keyed on a poisoned sample: the
    co-batch of 4 (a, b and the 2-sample poison p, whose second sample lands
    on replica 1 however it is batched) raises from its one dispatch, is
    bisected into [a, b] and [p], and p fails alone; a and b get their
    single-device logits."""
    model, x = _served("matrix")
    ps = model.plan_set(max_batch=4, dp=2)
    srv = CNNServer(ps, max_batch=4, max_wait_ms=10_000.0,
                    mesh=make_local_mesh((2, 2), ("data", "model")))
    poison = x[2:4].copy()
    poison[1, 0, 0, 0] = 1234.0
    for plan in srv.plan_set.plans.values():
        replica = plan.replicas[1]
        inner = replica.serve

        def planted(xb, inner=inner):
            if bool((xb[:, 0, 0, 0] == 1234.0).any()):
                raise RuntimeError("planted replica fault")
            return inner(xb)

        object.__setattr__(replica, "serve", planted)
    with srv:
        srv.warmup()
        futs = [srv.submit(x[0:1]), srv.submit(x[1:2]), srv.submit(poison)]
        a, b = futs[0].result(timeout=WAIT_S), futs[1].result(timeout=WAIT_S)
        with pytest.raises(RuntimeError, match="planted replica fault"):
            futs[2].result(timeout=WAIT_S)
    np.testing.assert_array_equal(a, ps.serve(x[0:1]))
    np.testing.assert_array_equal(b, ps.serve(x[1:2]))
    s = srv.stats.summary()
    assert (s["completed"], s["failed"]) == (2, 2)
    assert s["bucket_counts"] == {"2": 2, "4": 1}
    assert srv.retraces_after_warmup == 0
    srv.stats.assert_accounting()
