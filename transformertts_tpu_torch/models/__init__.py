from transformertts_tpu_torch.models.tts import TransformerTTS  # noqa: F401
from transformertts_tpu_torch.models.masks import (  # noqa: F401
    lengths_to_valid_mask,
    causal_bias,
    padding_bias,
)
