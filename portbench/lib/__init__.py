"""The benchmark's yardstick: inputs, shape arithmetic, peaks, trace reduction
and the harness that runs one cell."""
