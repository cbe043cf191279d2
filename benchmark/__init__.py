"""The port's benchmark: `python benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of BENCHMARK.json once."""
