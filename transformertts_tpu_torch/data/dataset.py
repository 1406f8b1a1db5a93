"""Bucket and statistics helpers of ``transformertts_tpu/data/dataset.py``.

Only what serving needs is ported: the data loader comes with the
training slice.
"""

from __future__ import annotations

import json
from bisect import bisect_left
from pathlib import Path


def load_stats(preprocessed_dir: str | Path) -> dict:
    with open(Path(preprocessed_dir) / "stats.json", encoding="utf-8") as f:
        return json.load(f)


def pick_bucket(value: int, buckets: tuple[int, ...]) -> int | None:
    """Smallest bucket >= value, or None if value exceeds the largest."""
    i = bisect_left(buckets, value)
    return buckets[i] if i < len(buckets) else None
