"""The benchmark of the PyTorch and CUDA port (`vampnet_tpu_torch`).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once on the card and prints one JSON line.
Everything that belongs to one configuration, traffic mix, per-layer metric
or cell's limits sits in a file of its own, found by name:

  configs/<config>.json    sizes and settings of a configuration
  traffic/<mix>.json       parameters of a traffic mix (read by `harness/traffic.py`)
  drivers/<kind>.py        how a kind of traffic drives the port (`serve`, `train`)
  metrics/<metric>.py      the reader of one per-layer metric
  limits/<cell>.json       the limits of the numbers that decide `correct`
  reference/               the plain fp32 reference (imports nothing of the port)
  compare/                 the comparisons that decide `correct`
  roofline.py              operations and bytes from shapes, and the H100's peaks
"""
