from transformertts_tpu_torch.data.dataset import (  # noqa: F401
    BucketedLoader,
    LJSpeechDataset,
    load_stats,
    pick_bucket,
)
