from transformertts_tpu_torch.models.tts import TransformerTTS  # noqa: F401
