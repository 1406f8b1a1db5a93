from transformertts_tpu_torch.dsp.mel import denormalize_mel  # noqa: F401
