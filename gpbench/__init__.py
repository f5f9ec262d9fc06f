"""The benchmark of albatross_tpu_torch on one NVIDIA H100 (``BENCHMARK.json``).

``python3 -m gpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once; ``README.md`` says how to add a configuration, a traffic
mix, a cell or a metric.  Nothing here imports JAX or the JAX package.
"""
