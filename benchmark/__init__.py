"""The benchmark of `vdetr_tpu_torch` on one NVIDIA H100.

`python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own under `configs/`, `traffic/` and
`metrics/`, found by the name `BENCHMARK.json` gives it. `reference/` is
the plain PyTorch model that decides `correct`; it imports nothing of the
program. Nothing here imports JAX or the JAX package.
"""
