"""The benchmark of grove_tpu_torch on one NVIDIA H100: `python3 -m
benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
(see README.md)."""
