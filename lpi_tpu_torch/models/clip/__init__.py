"""CLIP ViT-B/16 with LPI prompt injection and SliNet, the continual
retrieval model (counterpart of `lpi_tpu/models/clip`)."""

from lpi_tpu_torch.models.clip.model import CLIP, TextTransformer, VisionTransformer  # noqa: F401
from lpi_tpu_torch.models.clip.slinet import SliNet, init_parameters  # noqa: F401
