"""The command run as a check runs it, on a machine without a card, and
the import closure of everything it runs."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "starcoder2-7b.decode-b16", "--seed", str(2**31 + 5), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


CLOSURE = r"""
import sys, time
sys.path[:0] = [{src!r}, {root!r}]
from portbench.lib import harness
from portbench.tests.helpers import small_run
for w in ("starcoder2-7b.decode-b16", "starcoder2-7b.prefill-int8"):
    small_run(w, seconds=0.2, trace=True)
for w in [x["name"] for x in harness.manifest()["workloads"]]:
    cell = harness.resolve(w)
    cell.loop, cell.reference, [cell.reader(m["name"]) for m in cell.per_layer]
import runpy
sys.argv = ["run.py", "--help"]
try:
    runpy.run_path({run!r}, run_name="__main__")
except SystemExit:
    pass
print("FORBIDDEN", harness.forbidden_modules())
"""


def test_nothing_the_harness_runs_loads_jax_or_the_jax_package():
    code = CLOSURE.format(src=str(ROOT / "src"), root=str(ROOT),
                          run=str(ROOT / "portbench" / "run.py"))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout


def test_the_forbidden_names_are_compared_whole():
    from portbench.lib import harness

    sys.modules.setdefault("repro_torch_probe_name", sys)
    try:
        assert "repro_torch_probe_name" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_probe_name"]
