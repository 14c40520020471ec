"""The H100 benchmark of blackhole_simulation_tpu_torch: one command runs
one cell of BENCHMARK.json once (``python benchmark/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``). Nothing here imports JAX
or the JAX package; ``reference/`` imports nothing of the port either."""
