"""Building-block modules: Linear/LayerNorm/BatchNorm holders, LinearNorm,
ConvBN, prenets, postnet, scaled PE (``transformertts_tpu/models/modules.py``).

Every module that behaves differently in training takes ``train`` (default
False: no dropout, BatchNorm on its running statistics) and, for its
dropout, a ``DropoutRng``: explicit generators, never the global RNG.  The
dropout here is plain tensor code, as it is XLA code in the JAX package; the
dropout inside the attention and LayerNorm kernels is ``ops/dropout_mask.py``.
Numerics follow flax's: parameters are fp32 and are cast to the compute
``dtype`` at use; a dense layer rounds its matmul to ``dtype`` before adding
the bias, as ``flax.linen.Dense`` does.  Submodules carry the
flax names (``Dense_0``, ``ConvBN_2``, ...), so ``convert.py`` maps a flax
parameter path onto a state-dict key by joining it with dots.

Convolutions take the JAX package's feature-last (B, T, C) layout at the
module boundary and transpose to torch's (B, C, T) inside.

A module that a sharded step splits reads its ``layout``
(``parallel/mesh.py:Layout``; one process by default, which changes
nothing): a dropout draws the one-process mask and takes this rank's part,
BatchNorm sums its batch moments over the data ranks, and the convolution
stacks gather the time axis under sequence parallelism.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from transformertts_tpu_torch.models.initializers import normal_, xavier_normal_
from transformertts_tpu_torch.ops.dropout_mask import seed_from_generator
from transformertts_tpu_torch.parallel.mesh import SINGLE

# the mesh axes of an activation between blocks: rows over 'data', time over
# 'model' under sequence parallelism
ACT = ("data", "time")


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device))


class DropoutRng:
    """The random streams of one train-mode forward, both made from ``seed``:
    ``seeds`` (a CPU generator) gives each kernel call site its int32 mask
    seed without a device readback, ``masks`` (a generator on ``device``)
    draws the elementwise masks of the plain dropout."""

    def __init__(self, seed: int, device: str | torch.device = "cpu"):
        self.seeds = torch.Generator().manual_seed(int(seed))
        self.masks = torch.Generator(device=device).manual_seed(int(seed))

    def kernel_seed(self, rate: float) -> int:
        """A fresh seed for one kernel call (0 when its dropout is off)."""
        return seed_from_generator(rate, self.seeds)


def dropout(x: torch.Tensor, rate: float, train: bool, rng: Optional[DropoutRng],
            layout=SINGLE, axes: tuple = ()) -> torch.Tensor:
    """flax ``Dropout``: ``where(keep, x / (1 - rate), 0)`` with keep drawn
    from ``rng.masks``; the identity when not training or at rate 0.  On a
    sharded ``layout``, x is this rank's part of a tensor whose leading
    dimensions are split over ``axes`` (``Layout.span``): the mask is drawn
    at that tensor's shape and sliced (on one process, the whole of it)."""
    if not train or rate <= 0.0:
        return x
    if rng is None:
        raise ValueError("train-mode dropout needs a DropoutRng")
    shape, index = layout.global_view(x.shape, axes)
    keep = (torch.rand(shape, generator=rng.masks, device=x.device) >= rate)[index]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Linear(nn.Module):
    """Weight (out, in) and bias, without torch's own (global-RNG) init."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        super().__init__()
        self.weight = _param(out_features, in_features, device=device)
        self.bias = _param(out_features, device=device) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """flax ``Dense(dtype=...)``: matmul in ``dtype``, then + bias in ``dtype``."""
        y = x.to(dtype) @ self.weight.to(dtype).t()
        return y + self.bias.to(dtype) if self.bias is not None else y


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and output in ``dtype`` (eps 1e-5)."""

    def __init__(self, d: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.weight = _param(d, device=device)
        self.bias = _param(d, device=device)
        self.dtype = dtype

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, 1e-5)
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax's semantics (momentum 0.9,
    eps 1e-5).

    Eval: the running statistics.  Train: the batch's statistics over every
    leading position (padding included), in fp32, the variance biased and
    computed as ``E[x^2] - E[x]^2`` clamped at 0; the SAME biased variance
    goes into ``running_var`` as ``0.9 * running + 0.1 * batch`` (flax's
    rule; ``torch.nn.BatchNorm1d`` would store the unbiased one).  The
    buffers are updated in place.  Arithmetic as flax's ``_normalize``:
    promoted to fp32, cast to ``dtype`` at the end.  Over data ranks the
    sums of x and x^2 are summed over the ranks (forward and backward), so
    every rank normalises and updates with the global batch's statistics;
    the time axis is always whole here (the stacks gather it).
    """

    momentum = 0.9
    layout = SINGLE

    def __init__(self, d: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.weight = _param(d, device=device)
        self.bias = _param(d, device=device)
        self.register_buffer("running_mean", torch.empty(d, device=device))
        self.register_buffer("running_var", torch.empty(d, device=device))
        self.dtype = dtype

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.float()
        if train:
            flat = x32.reshape(-1, x32.shape[-1])
            sums = self.layout.sum_data(torch.stack([flat.sum(dim=0), (flat * flat).sum(dim=0)]))
            count = flat.shape[0] * self.layout.mesh.n_data
            mean = sums[0] / count
            var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + 1e-5) * self.weight
        y = (x32 - mean) * mul + self.bias
        return y.to(self.dtype)


class LinearNorm(nn.Module):
    """Dense with torch xavier_normal(gain(activation)) init, zero bias."""

    def __init__(
        self, in_features: int, features: int, use_bias: bool = True,
        activation: str = "relu", dtype: torch.dtype = torch.float32, device=None,
    ):
        super().__init__()
        self.Dense_0 = Linear(in_features, features, use_bias, device=device)
        self.activation = activation
        self.dtype = dtype

    def reset_parameters(self, generator) -> None:
        xavier_normal_(self.Dense_0.weight, self.activation, generator)
        if self.Dense_0.bias is not None:
            nn.init.zeros_(self.Dense_0.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x, self.dtype)


class Conv(nn.Module):
    """Same-padded Conv1d on (B, T, C); weight (out, in, k)."""

    def __init__(self, in_features: int, features: int, kernel_size: int, device=None):
        super().__init__()
        self.weight = _param(features, in_features, kernel_size, device=device)
        self.bias = _param(features, device=device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        pad = (self.weight.shape[2] - 1) // 2
        y = F.conv1d(x.to(dtype).transpose(1, 2), self.weight.to(dtype), padding=pad)
        return y.transpose(1, 2) + self.bias.to(dtype)


class ConvBN(nn.Module):
    """Same-padded Conv1d + BatchNorm, feature-last. No activation inside."""

    def __init__(
        self, in_features: int, features: int, kernel_size: int,
        activation: str = "relu", dtype: torch.dtype = torch.float32, device=None,
    ):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel_size, device=device)
        self.BatchNorm_0 = BatchNorm(features, dtype, device=device)
        self.activation = activation
        self.dtype = dtype

    def reset_parameters(self, generator) -> None:
        xavier_normal_(self.Conv_0.weight, self.activation, generator)
        nn.init.zeros_(self.Conv_0.bias)
        self.BatchNorm_0.reset_parameters()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.BatchNorm_0(self.Conv_0(x, self.dtype), train)


class EncoderPreNet(nn.Module):
    """N x [ConvBN + Dropout] + final LinearNorm (ref: model/model.py:13-45);
    no ReLU.  Under sequence parallelism the convolution stack runs on the
    gathered time axis and the rank keeps its slice after it."""

    layout = SINGLE

    def __init__(self, n_layers, features, kernel_size, dropout=0.5, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = dropout
        for i in range(n_layers):
            setattr(self, f"ConvBN_{i}", ConvBN(
                features, features, kernel_size, "relu", dtype, device=device))
        self.LinearNorm_0 = LinearNorm(features, features, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool = False, rng=None) -> torch.Tensor:
        x = self.layout.gather_time(x)
        for i in range(self.n_layers):
            x = dropout(getattr(self, f"ConvBN_{i}")(x, train), self.dropout, train, rng,
                        self.layout, ("data",))
        return self.LinearNorm_0(self.layout.local_time(x))


class DecoderPreNet(nn.Module):
    """2 x [LinearNorm -> ReLU -> Dropout] (ref: model/model.py:48-67);
    dropout only in training."""

    layout = SINGLE

    def __init__(self, n_mels, d_model, dropout=0.5, dtype=torch.float32, device=None):
        super().__init__()
        self.dropout = dropout
        self.LinearNorm_0 = LinearNorm(n_mels, d_model, dtype=dtype, device=device)
        self.LinearNorm_1 = LinearNorm(d_model, d_model, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool = False, rng=None) -> torch.Tensor:
        x = dropout(torch.relu(self.LinearNorm_0(x)), self.dropout, train, rng, self.layout, ACT)
        return dropout(torch.relu(self.LinearNorm_1(x)), self.dropout, train, rng, self.layout,
                       ACT)


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """Standard sinusoidal PE table (ref: model/model.py:80-85)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class ScaledPositionalEncoding(nn.Module):
    """x + alpha * PE[offset:offset+T], then dropout; ONE learnable scalar
    alpha, shared by the encoder and the decoder (reference quirk,
    model/model.py:288,297).  Under sequence parallelism x is a time slice
    and takes the table at its global positions."""

    layout = SINGLE

    def __init__(self, d_model: int, max_len: int = 5000, dropout: float = 0.1, device=None):
        super().__init__()
        self.dropout = dropout
        self.alpha = _param(1, device=device)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoid_table(max_len, d_model)).to(device),
            persistent=False,
        )

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.alpha)

    def forward(self, x: torch.Tensor, offset: int = 0, train: bool = False,
                rng=None) -> torch.Tensor:
        offset += self.layout.time_offset(x.shape[-2])
        table = self.pe[offset: offset + x.shape[-2]]
        return dropout(x + (self.alpha * table[None]).to(x.dtype), self.dropout, train, rng,
                       self.layout, ACT)


class PostNet(nn.Module):
    """5-layer conv postnet (ref: model/model.py:100-135); Tanh after every
    block but the last, dropout after every block; the residual add happens
    in the caller.  Under sequence parallelism it runs on the gathered time
    axis and returns the rank's slice."""

    layout = SINGLE

    def __init__(self, n_layers, n_mels, d_model, kernel_size, dropout=0.5,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = dropout
        widths = [n_mels] + [d_model] * (n_layers - 1) + [n_mels]
        for i in range(n_layers):
            setattr(self, f"ConvBN_{i}", ConvBN(
                widths[i], widths[i + 1], kernel_size, "tanh", dtype, device=device))

    def forward(self, x: torch.Tensor, train: bool = False, rng=None) -> torch.Tensor:
        x = self.layout.gather_time(x)
        whole = (self.layout, ("data",))
        for i in range(self.n_layers - 1):
            x = dropout(torch.tanh(getattr(self, f"ConvBN_{i}")(x, train)), self.dropout, train,
                        rng, *whole)
        x = dropout(getattr(self, f"ConvBN_{self.n_layers - 1}")(x, train), self.dropout, train,
                    rng, *whole)
        return self.layout.local_time(x)


class Embed(nn.Module):
    """Token embedding, N(0, 1) init (torch nn.Embedding); fp32 output."""

    def __init__(self, n: int, d: int, device=None):
        super().__init__()
        self.weight = _param(n, d, device=device)

    def reset_parameters(self, generator) -> None:
        normal_(self.weight, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)
