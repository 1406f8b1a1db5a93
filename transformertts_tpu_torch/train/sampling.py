"""Block-wise scheduled sampling (``transformertts_tpu/train/sampling.py``;
ref: utils/util.py:103-120, lightning_module.py:53-74).

Per frame, draw Bernoulli(1 - p_tf) seeds, dilate them into ~L_bar-wide
blocks with a stride-1 max-pool (kernel L_bar, pad L_bar // 2, output cropped
to T), and replace ground-truth frames with detached model predictions
inside the blocks; zero everything beyond the valid length.

The dilation takes the seed bits as an input (``dilate_seeds``), so that a
test can feed it the very bits another implementation drew; ``block_mask``
draws them from an explicit generator.  On a sharded model the mask is drawn
and dilated at the one-process batch's shape and this rank's rows (and time
slice) are taken from it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from transformertts_tpu_torch.models.masks import lengths_to_valid_mask
from transformertts_tpu_torch.parallel.mesh import SINGLE


def dilate_seeds(seeds: torch.Tensor, l_bar: int = 8) -> torch.Tensor:
    """(B, T) bool seeds -> (B, T) bool blocks: position t is True when any
    seed lies in [t - l_bar // 2, t - l_bar // 2 + l_bar)."""
    t = seeds.shape[1]
    pooled = F.max_pool1d(seeds.float()[:, None, :], kernel_size=l_bar, stride=1,
                          padding=l_bar // 2)
    return pooled[:, 0, :t] > 0.5


def block_mask(generator: torch.Generator, batch: int, t: int, p_tf: float,
               l_bar: int = 8) -> torch.Tensor:
    """(B, T) bool mask: True = use the model's prediction instead of ground
    truth.  Drawn on the generator's device."""
    seeds = torch.rand((batch, t), generator=generator, device=generator.device) < (1.0 - p_tf)
    return dilate_seeds(seeds, l_bar)


def apply_teacher_forcing(
    generator: torch.Generator,
    pred_melspec: torch.Tensor,  # (B, T, C) first-pass predictions
    melspec: torch.Tensor,  # (B, T, C) ground truth
    melspec_lens: torch.Tensor,  # (B,)
    p_tf: float,
    l_bar: int = 8,
    layout=SINGLE,
) -> torch.Tensor:
    """Mix detached predictions into GT in blocks, zero past valid length."""
    b, t, _ = pred_melspec.shape
    (b_total, t_total), index = layout.global_view((b, t), ("data", "time"))
    mask = block_mask(generator, b_total, t_total, p_tf, l_bar)[index].to(melspec.device)
    return mix_teacher_forcing(mask, pred_melspec, melspec, melspec_lens, index[1].start)


def mix_teacher_forcing(mask, pred_melspec, melspec, melspec_lens, t0: int = 0) -> torch.Tensor:
    """``apply_teacher_forcing`` for a given (B, T) block mask; ``t0`` is the
    first frame's position (a time slice)."""
    mixed = torch.where(mask[:, :, None], pred_melspec.detach(), melspec)
    valid = lengths_to_valid_mask(melspec_lens, melspec.shape[1], t0)[:, :, None]
    return torch.where(valid, mixed, torch.zeros_like(mixed))
