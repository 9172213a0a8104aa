"""What the CPU runs of the benchmark's tests share."""
import time

from portbench.lib import harness

# the CPU runs' sizes: every width and depth small, the traffic as the cell has it
SMALL = {
    "starcoder2-7b": {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
                      "head_dim": 16, "d_ff": 128, "vocab_size": 512},
}


def small_run(workload, *, faults=(), trace=False, seconds=0.5, seed=2**31 + 17):
    """One run of ``workload`` on the CPU at its configuration's small sizes."""
    cfg = harness.resolve(workload).entry["config"]
    return harness.run_cell(workload, seed, seconds, trace, "cpu", t_start=time.time(),
                            overrides=SMALL[cfg], faults=faults)
