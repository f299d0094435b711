"""A plain PyTorch and NumPy FastPM run, independent of fastpm_torch:
what the benchmark holds the port's output against."""
