"""The benchmark of the PyTorch and CUDA port (`lpi_tpu_torch`) on an H100:
`python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1`
(see README.md)."""
