"""The benchmark of `streammos_tpu_torch` on NVIDIA H100: one command runs
one cell (`python3 portbench/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>`); the cells, metrics and bounds are `BENCHMARK.json`'s.
"""
