"""Console + rotating-file logging (``transformertts_tpu/utils/logging.py``;
ref: utils/util.py:123-132 uses loguru; stdlib logging with the same
behaviour: colored INFO on stdout, DEBUG to ``train.log`` with 10 MB
rotation)."""

from __future__ import annotations

import logging
import sys
from logging.handlers import RotatingFileHandler
from pathlib import Path

_FMT = "%(asctime)s | %(levelname)s | %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"

_COLORS = {"DEBUG": "\x1b[36m", "INFO": "\x1b[32m", "WARNING": "\x1b[33m",
           "ERROR": "\x1b[31m", "CRITICAL": "\x1b[41m"}


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelname, "")
        return f"{color}{msg}\x1b[0m" if color and sys.stdout.isatty() else msg


def setup_logger(log_path: str | None = None, name: str = "transformertts_tpu_torch"):
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()

    console = logging.StreamHandler(sys.stdout)
    console.setLevel(logging.INFO)
    console.setFormatter(_ColorFormatter(_FMT, _DATEFMT))
    logger.addHandler(console)

    if log_path:
        Path(log_path).parent.mkdir(parents=True, exist_ok=True)
        fileh = RotatingFileHandler(log_path, maxBytes=10 * 1024 * 1024, backupCount=3)
        fileh.setLevel(logging.DEBUG)
        fileh.setFormatter(logging.Formatter(_FMT, _DATEFMT))
        logger.addHandler(fileh)
    logger.propagate = False
    return logger


def log_step_info(logger, epoch: int, step: int, metrics: dict, lr: float,
                  throughput: float | None = None):
    """Per-step loss line (ref: lightning_module.py:180-196)."""
    parts = [f"epoch {epoch:3d} | step {step:7d}"]
    for key in ("total", "pred_mel", "post_mel", "stop"):
        if key in metrics:
            parts.append(f"{key} {float(metrics[key]):.4f}")
    parts.append(f"lr {lr:.3e}")
    if throughput is not None:
        parts.append(f"audio-s/s {throughput:.1f}")
    logger.info(" | ".join(parts))
