"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on the card and
prints one JSON line.  Cells, configurations, traffic mixes and per-layer
metrics are found by name: `configs/<config>.json`, `traffic/<mix>.json`,
`metrics/<metric>.py`.  `reference/` is the plain float32 model that
decides `correct`; it imports nothing of the port.
"""
