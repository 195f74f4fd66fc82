"""The benchmark of the PyTorch port: a harness driven by the files under
`benchmark/` and the entries of `BENCHMARK.json` (see `manifest.py`)."""
