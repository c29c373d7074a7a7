"""portbench: the benchmark of csinn2_tpu_torch's LLM server on one H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json; see README.md."""
