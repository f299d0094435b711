"""The benchmark of fastpm_torch (the PyTorch and CUDA port of FastPM):
one cell a run through run.py, each cell found by name from
BENCHMARK.json at the root of the checkout."""
