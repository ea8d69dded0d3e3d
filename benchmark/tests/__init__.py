"""CPU tests of the benchmark (`python -m pytest benchmark/tests`); the one
marked `gpu` runs a short cell on a CUDA card and skips without one."""
