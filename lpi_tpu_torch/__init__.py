"""LPI grounding in PyTorch with CUDA kernels for Hopper.

The PyTorch counterpart of `lpi_tpu`, which stays the reference: the same
configs and model, ported slice by slice. This package imports neither JAX
nor `lpi_tpu`. The serving entry point is
`lpi_tpu_torch.serve.predictor.GroundingPredictor`.
"""
