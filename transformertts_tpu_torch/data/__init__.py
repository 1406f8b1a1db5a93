from transformertts_tpu_torch.data.dataset import load_stats, pick_bucket  # noqa: F401
