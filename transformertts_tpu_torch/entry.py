"""Entry points of the port for an outside harness that checks a model (the
counterpart of the JAX package's ``__graft_entry__.py``).

- ``entry(device=None)``: the eval-mode teacher-forced forward of the
  flagship model (``Config()``, the reference-parity LJSpeech model) and an
  example batch of 16 rows, 128 phonemes and 512 mel frames, on the GPU
  unless the caller names another device.
- ``dryrun_multichip(n)``: one sharded training step over n devices; it
  waits on the port of ``parallel/mesh.py`` (ROADMAP Queue 1 item 6) and
  raises.
"""

from __future__ import annotations

import numpy as np
import torch

from transformertts_tpu_torch.config import Config
from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.models import TransformerTTS


def entry(device: str | torch.device | None = None):
    """Returns (fn, example_args): ``fn(*example_args)`` is the forward's
    dict of ``pred_melspec`` / ``pred_stop`` / ``post_melspec`` /
    ``alignments``."""
    device = resolve_device(device)
    cfg = Config().validate()
    dtype = torch.bfloat16 if cfg.runtime.compute_dtype == "bfloat16" else torch.float32
    model = TransformerTTS(cfg.model, dtype=dtype, device=device)
    b, tp, tm = 16, 128, 512
    rng = np.random.default_rng(0)
    phoneme = torch.from_numpy(rng.integers(1, 60, (b, tp))).to(device)
    melspec = torch.from_numpy(
        rng.standard_normal((b, tm, cfg.model.n_mels)).astype(np.float32)).to(device)
    p_lens = torch.full((b,), tp, dtype=torch.long, device=device)
    m_lens = torch.full((b,), tm, dtype=torch.long, device=device)

    @torch.inference_mode()
    def forward(phoneme, melspec, p_lens, m_lens):
        return model(phoneme, melspec, p_lens, m_lens)

    return forward, (phoneme, melspec, p_lens, m_lens)


def dryrun_multichip(n_devices: int) -> None:
    """One sharded training step over ``n_devices`` devices: not ported."""
    raise NotImplementedError(
        f"dryrun_multichip({n_devices}) needs parallel/mesh.py, not ported yet "
        "(ROADMAP Queue 1 item 6)")
