from transformertts_tpu_torch.train.loss import tts_loss, guided_attention_loss  # noqa: F401
from transformertts_tpu_torch.train.schedules import noam_schedule, teacher_forcing_ratio  # noqa: F401
from transformertts_tpu_torch.train.sampling import block_mask, apply_teacher_forcing  # noqa: F401
from transformertts_tpu_torch.train.train_step import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
    make_eval_step,
)
