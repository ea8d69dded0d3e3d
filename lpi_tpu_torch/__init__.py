"""LPI grounding and continual retrieval in PyTorch with CUDA kernels for
Hopper.

The PyTorch counterpart of `lpi_tpu`, which stays the reference: the same
configs and models, ported slice by slice. This package imports neither JAX
nor `lpi_tpu`. Entry points: `lpi_tpu_torch.serve.predictor.GroundingPredictor`
(serving), `lpi_tpu_torch.continual.grounding_learner.GroundingLearner`
(grounding training and evaluation),
`lpi_tpu_torch.continual.learner.RetrievalLearner` (continual retrieval:
SliNet, CLIP ViT-B/16 with LPI prompts), `lpi_tpu_torch.bench`
(`bench_retrieval` and the two quality gates) and the command line,
`python -m lpi_tpu_torch.cli.main` (its `train` also under torchrun, one
rank of a data- and tensor-parallel mesh: `lpi_tpu_torch.core.mesh`).
"""
