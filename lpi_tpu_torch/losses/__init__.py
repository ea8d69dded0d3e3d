from lpi_tpu_torch.losses.clip_loss import (  # noqa: F401
    alignment_loss,
    clip_loss,
    global_clip_loss,
    info_nce,
    nt_bxent_loss,
    nt_bxent_loss_masked,
    task_prompt_loss,
    task_prompt_loss_masked,
)
