"""The control on the card, at each cell's own size: the reference computed in
the precision below the configuration's, in the program's place, fails the
cell's limits on three seeds. Card only: ``python -m pytest -m cuda
portbench/tests/test_portbench_control.py``."""
import gc

import pytest
import torch

from portbench.lib import harness

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
SECONDS = {"starcoder2-7b.decode-b16": 1, "starcoder2-7b.prefill-int8": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SECONDS))
def test_the_control_fails_the_limits(card, workload):
    cell = harness.resolve(workload)
    for seed in SEEDS:
        ctx = harness.Context(cell, dict(cell.config), seed, card)
        loop = cell.loop.Loop(ctx)
        loop.setup()
        ctx.rec = loop.window(SECONDS[workload], None)
        loop.free()
        gc.collect()
        torch.cuda.empty_cache()
        checks = loop.check(control=True)
        assert any(c["value"] > c["limit"] for c in checks), (seed, checks)
        del loop, ctx
        gc.collect()
        torch.cuda.empty_cache()
