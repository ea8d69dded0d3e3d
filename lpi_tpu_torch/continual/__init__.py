from lpi_tpu_torch.continual.keys import TaskKeys, infer_task_ids  # noqa: F401
from lpi_tpu_torch.continual.freeze import trainable_mask, mask_grads  # noqa: F401
from lpi_tpu_torch.continual.early_stop import EarlyStopper  # noqa: F401
from lpi_tpu_torch.continual.exemplars import ExemplarMemory, herding_selection  # noqa: F401
from lpi_tpu_torch.continual.schedules import (  # noqa: F401
    WarmupReduceLROnPlateau,
    warmup_cosine,
    warmup_multistep,
)
