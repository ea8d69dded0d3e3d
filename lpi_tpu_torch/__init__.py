"""LPI grounding in PyTorch with CUDA kernels for Hopper.

The PyTorch counterpart of `lpi_tpu`, which stays the reference: the same
configs and model, ported slice by slice. This package imports neither JAX
nor `lpi_tpu`. Entry points: `lpi_tpu_torch.serve.predictor.GroundingPredictor`
(serving), `lpi_tpu_torch.continual.grounding_learner.GroundingLearner`
(training and evaluation) and `lpi_tpu_torch.bench.bench_quality_grounding`
(the grounding quality gate).
"""
