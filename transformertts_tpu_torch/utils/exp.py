"""Experiment directory management (``transformertts_tpu/utils/exp.py``;
ref: utils/util.py:18-35)."""

from __future__ import annotations

import os
from datetime import datetime, timedelta, timezone
from pathlib import Path

KST = timezone(timedelta(hours=9))  # ref: utils/util.py:15

PLOT_SUBDIRS = (
    "mels_batch", "mels_single", "align_batch", "align_single", "mels_scheduled",
)


def increment_path(base_path: str | Path) -> str:
    """Create ``exp_{N}_{MMDD-HHMM}`` with the 5 plot subdirs, N auto-increment."""
    base = Path(base_path)
    base.mkdir(parents=True, exist_ok=True)
    ts = datetime.now(KST).strftime("%m%d-%H%M")
    exp_num = 1
    existing = os.listdir(base)
    while True:
        prefix = f"exp_{exp_num}"
        if not any(name.startswith(prefix + "_") or name == prefix for name in existing):
            path = base / f"{prefix}_{ts}"
            for sub in PLOT_SUBDIRS:
                (path / sub).mkdir(parents=True, exist_ok=True)
            return str(path)
        exp_num += 1
