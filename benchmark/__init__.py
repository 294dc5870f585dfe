"""The benchmark of quantpy_tpu_torch on the card (see BENCHMARK.json and
PERF.md): `python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout."""
