"""Faults planted underneath the timed path, for the tests and for
reading a limit's upper end on the chip (``control.py --fault``).  Each
``plant(kind)`` patches the program in this process and returns an undo.

- ``unchanged``: a step that returns its state unchanged (serving: the
  decode step leaves its frames unwritten from position 5 on; training: the
  optimizer step leaves the parameters as they were);
- ``half``: half of the batch left out (serving: the second half of each
  batch's rows left unwritten; training: the loss over the first half of
  the rows, the mean taken over those);
- ``altered``: an answer altered where it is produced (serving: one frame
  at position 10; training: one parameter's update).
"""

from __future__ import annotations

import torch


def plant(kind: str, training: bool):
    if training:
        from transformertts_tpu_torch.train import train_step as mod

        if kind == "unchanged":
            return _patch(mod.AdamNoam, "apply_", lambda self, *a, **k: None)
        if kind == "half":
            orig = mod.tts_loss

            def half(outputs, mel, lengths, *a, **k):
                h = mel.shape[0] // 2
                return orig({n: v[:h] for n, v in outputs.items()}, mel[:h], lengths[:h],
                            *a, **k)
            return _patch(mod, "tts_loss", half)
        if kind == "altered":
            orig_apply = mod.AdamNoam.apply_

            def apply_(self, params, grads, state, norm):
                orig_apply(self, params, grads, state, norm)
                with torch.no_grad():
                    next(iter(params.values())).mul_(1.001)
            return _patch(mod.AdamNoam, "apply_", apply_)
        raise ValueError(kind)
    from transformertts_tpu_torch.infer import decode

    orig_step = decode.DecodeRows.step

    def step(self):
        t = self.t
        if kind == "unchanged" and t >= 5:
            self.t += 1
            return
        orig_step(self)
        if kind == "altered" and t == 10:
            self.frames[:, t + 1] += 2.0
        if kind == "half" and self.b > 1:
            self.frames[self.b // 2:, t + 1] = 0.0
    if kind not in ("unchanged", "altered", "half"):
        raise ValueError(kind)
    return _patch(decode.DecodeRows, "step", step)


def _patch(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    return lambda: setattr(owner, name, old)
