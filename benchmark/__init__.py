"""The benchmark of the PyTorch / CUDA port (`omnihuman_tpu_torch`).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on the card it is started
on and prints one JSON line. Everything a cell needs is found by name:
`configs/<config>.json`, `traffic/<mix>.json`, `drivers/<driver>.py` and
`metrics/<metric>.py`; `reference/` is the plain fp32 PyTorch that decides
`correct`. Nothing here imports JAX or the JAX package.
"""
