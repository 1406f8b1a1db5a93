from transformertts_tpu_torch.utils.exp import increment_path  # noqa: F401
from transformertts_tpu_torch.utils.logging import setup_logger, log_step_info  # noqa: F401
