"""Learning-rate and teacher-forcing schedules
(``transformertts_tpu/train/schedules.py``).

- Noam LR (ref: utils/util.py:42-49): Adam base lr 1.0 scaled by
  ``d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)``, per optimizer step.
- Teacher-forcing ratio (ref: utils/util.py:54-92): per epoch, 1.0 for the
  first ``warmup_epochs``, then linear (floor 0.05) / cosine (clamped to
  [0.5, 1.0]) / constant.
"""

from __future__ import annotations

import math


def noam_schedule(d_model: int, warmup_steps: int):
    """Returns fn(step: int) -> lr, with step clamped to at least 1."""
    scale = d_model ** -0.5

    def schedule(step: int) -> float:
        s = float(max(int(step), 1))
        return scale * min(s ** -0.5, s * (warmup_steps ** -1.5))

    return schedule


def teacher_forcing_ratio(
    epoch: int,
    total_epochs: int = 300,
    mode: str = "linear",
    warmup_epochs: int = 10,
    constant_value: float = 1.0,
    cosine_cycles: int = 1,
) -> float:
    if epoch < warmup_epochs:
        return 1.0
    epoch_adj = epoch - warmup_epochs
    total_adj = max(total_epochs - warmup_epochs, 1)

    if mode == "cosine":
        ratio = 0.5 * math.cos(math.pi * epoch_adj * cosine_cycles / total_adj) + 0.5
        return max(min(ratio, 1.0), 0.5)
    if mode == "linear":
        return max(1.0 - epoch_adj / total_adj, 0.05)
    if mode == "constant":
        return constant_value
    raise ValueError(f"Unsupported teacher forcing mode: {mode}")
