"""The benchmark of the PyTorch and CUDA port (`spnerf_torch`): one cell of
`BENCHMARK.json` run once by `benchmark/run.py`. See benchmark/README.md."""
