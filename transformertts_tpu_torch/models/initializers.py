"""Seeded weight init with the distributions of the JAX package's
initializers (``transformertts_tpu/models/initializers.py``), which follow
the reference's torch init.

Every function draws from an explicit ``torch.Generator``, so a seed fixes
the weights.  The numbers differ from JAX's for the same seed; the
distributions are the same.  Fans follow torch's layouts: Linear weight
(out, in), Conv1d weight (out, in, k).
"""

from __future__ import annotations

import math

import torch

GAINS = {"linear": 1.0, "relu": math.sqrt(2.0), "tanh": 5.0 / 3.0, "sigmoid": 1.0}


def _fans(w: torch.Tensor) -> tuple[int, int]:
    if w.dim() == 2:  # Linear: (out, in)
        return w.shape[1], w.shape[0]
    if w.dim() == 3:  # Conv1d: (out, in, k)
        rf = w.shape[2]
        return w.shape[1] * rf, w.shape[0] * rf
    raise ValueError(f"unsupported weight shape {tuple(w.shape)}")


@torch.no_grad()
def xavier_normal_(w: torch.Tensor, gain_or_activation: float | str, generator):
    """torch ``xavier_normal_``: N(0, gain^2 * 2/(fan_in+fan_out))."""
    gain = (
        GAINS[gain_or_activation]
        if isinstance(gain_or_activation, str)
        else float(gain_or_activation)
    )
    fan_in, fan_out = _fans(w)
    return w.normal_(0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)


@torch.no_grad()
def xavier_uniform_(w: torch.Tensor, generator, gain: float = 1.0):
    """torch ``xavier_uniform_`` (MHA in-projections)."""
    fan_in, fan_out = _fans(w)
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def torch_linear_(w: torch.Tensor, generator, fan_in: int | None = None):
    """torch nn.Linear default, kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in)).

    Also the Linear bias init, with the layer's ``fan_in`` given."""
    fan_in = fan_in if fan_in is not None else _fans(w)[0]
    bound = 1.0 / math.sqrt(fan_in)
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_(w: torch.Tensor, generator, std: float = 1.0):
    """N(0, std^2) — torch nn.Embedding's default with std 1."""
    return w.normal_(0.0, std, generator=generator)
