"""lavbench: the benchmark of lav_tpu_torch on one NVIDIA H100.

    python3 -m lavbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of `BENCHMARK.json` once and prints one JSON line.  The
harness is driven by data: a cell names a configuration
(`configs/<config>.json`), a traffic mix (`traffic/<traffic>.json`, whose
`loop` names the generator in `loops/`) and the limits of its
correctness check (`limits/<cell>.json`); each per-layer metric is a
reader `metrics/<metric>.py`.  Everything that measures (the traffic, the
trace reduction, the peaks, the op and byte counts, the plain reference
under `ref/` and the comparison) lives here, so that it stays fixed while
the program changes.  Nothing here imports `jax` or `lav_tpu`.
"""
