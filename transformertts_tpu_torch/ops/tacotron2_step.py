"""One decoder step of Tacotron 2 on the GPU (``ops/csrc/tacotron2_step.cu``).

It replaces no TPU kernel: the JAX package has no Tacotron 2.  It was added
because nothing else in ``ops/`` computes location-sensitive attention or
an LSTM cell, and the step is a strict chain that a loop of PyTorch calls
would spread over some forty launches.

The step (``models/tacotron2.py``: prenet, attention LSTM, attention,
decoder LSTM, projections) is one persistent cooperative launch of a block
an SM, whose eight stages a grid barrier separates (the step's state holds
the barrier's two words), so a step costs the host one C call and one
launch.  Each stage's work items are dealt over the blocks:

- a warp per output row (``gemv_item``): each prenet layer with
  its ReLU and dropout masks (``dropout_mask.cuh``, the keep bits of
  ``prenet_keep``), the query ``W_q h1``, and last the projection
  ``[W_proj; w_gate] [h2; ctx] + b``;
- a warp per hidden unit (``lstm_item``, its four gate rows of
  ``[W_ih | W_hh]`` against [x; h] of every row, then the cell): the
  attention LSTM, and later the decoder LSTM;
- ``energy_item`` (an item per 8 positions of a row): the
  location term through ``wloc = W_ld W_conv`` (the 1 x 1 dense folded into
  the convolution's 2 x 31 taps, fp32), ``tanh``, the dot with ``v``;
- ``context_item`` (an item per 128 columns of a row's context):
  the masked softmax, the new weights and their running sum, and the
  context.

What bounds it on an H100: bytes.  At Tacotron 2's widths a step reads
18.2 M parameters (36.4 MB in bf16: the two LSTMs' 7.3 M and 10.5 M) and
the encoder memory of its rows, ~11.5 us at 3.35 TB/s for 8 rows; the
arithmetic is 2 FLOPs a weight a row, far below the tensor cores' rate, so
the products run on the CUDA cores in fp32 from 16-byte loads of bf16
weights.  The chain of dependent stages makes it latency-bound in
practice; the weights (36.4 MB) can stay in the card's 50-MB L2 between
steps.

Numerics (``tacotron2_step_reference`` op for op): every product takes
``dtype`` operands (the activations rounded when a stage loads them) and
sums in fp32; biases, ``v`` and ``wloc`` are fp32 values of the
``dtype``-rounded weights; the LSTM states, the attention weights, their
running sum, the energies and the context stay fp32.  The sums run in
another order than the reference's; no atomics, so a step is
deterministic.

The state (``Tacotron2State``) lives on the device between steps; h1 and h2
are double-buffered by the step's parity (every block of an LSTM stage
reads all of the old h while others write the new).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from transformertts_tpu_torch.ops.decode_step import MAX_BATCH, prenet_drop_args, prenet_keep

ENERGY_POSITIONS = 8  # encoder positions of one energy block (kPositions)
CONTEXT_COLS, CONTEXT_GROUPS = 128, 16  # a context block's columns and position groups
MAX_TP = 8192  # encoder positions the context stage holds in shared memory
SMEM_LIMIT = 232_448

# order of the pointers in the CUDA source's Args
_WEIGHTS = ("pw1", "pw2", "w1", "b1", "wq", "wloc", "v", "w2", "b2", "wp", "bp")
_STATE = ("h1", "c1", "h2", "c2", "alpha", "alpha_cum", "ctx", "p", "q", "energy", "y", "p1",
          "bar")


@torch.no_grad()
def pack_tacotron2_weights(model, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decoder step's weights of a ``Tacotron2`` in the kernel's layout:
    matrices (out, in) row-major in ``dtype``, each LSTM's [W_ih | W_hh] as
    one matrix with ``b_ih + b_hh`` in fp32, the projection and the gate as
    one (n_mels + 1, D) matrix, ``v`` and ``wloc`` (A, 2 k: the location
    dense times the location convolution, channel-major taps) in fp32."""
    d = model.decoder
    att = d.attention_layer

    def w(t):
        return t.detach().to(dtype).contiguous()

    def r32(t):  # fp32 values of the dtype-rounded tensor
        return t.detach().to(dtype).float().contiguous()

    n_f, _, k = att.location_conv.shape
    wloc = r32(att.location_dense.Dense_0.weight) @ r32(att.location_conv).reshape(n_f, 2 * k)
    lstm = lambda c: torch.cat([c.weight_ih, c.weight_hh], 1)  # noqa: E731
    return {
        "pw1": w(d.prenet.LinearNorm_0.Dense_0.weight),
        "pw2": w(d.prenet.LinearNorm_1.Dense_0.weight),
        "w1": w(lstm(d.attention_rnn)),
        "b1": (d.attention_rnn.bias_ih + d.attention_rnn.bias_hh).detach().float().contiguous(),
        "wq": w(att.query_layer.Dense_0.weight),
        "wloc": wloc.contiguous(),
        "v": r32(att.v.Dense_0.weight[0]),
        "w2": w(lstm(d.decoder_rnn)),
        "b2": (d.decoder_rnn.bias_ih + d.decoder_rnn.bias_hh).detach().float().contiguous(),
        "wp": w(torch.cat([d.linear_projection.Dense_0.weight, d.gate_layer.Dense_0.weight])),
        "bp": r32(torch.cat([d.linear_projection.Dense_0.bias, d.gate_layer.Dense_0.bias])),
    }


def widths(packed: dict) -> dict:
    """The step's sizes from its packed weights."""
    p, n_mels = packed["pw1"].shape
    h1 = packed["w1"].shape[0] // 4
    h2 = packed["w2"].shape[0] // 4
    enc = packed["w1"].shape[1] - p - h1
    return {"n_mels": n_mels, "prenet": p, "h1": h1, "h2": h2, "enc": enc,
            "att": packed["wq"].shape[0], "loc_k": packed["wloc"].shape[1] // 2}


class Tacotron2State:
    """The decoder state of b rows over tp encoder positions, zero at the go
    frame, plus the step's scratch: ``h1``, ``h2`` (2, B, H) by parity,
    ``c1``, ``c2`` (B, H), ``alpha``, ``alpha_cum`` (B, Tp), ``ctx`` (B, E),
    ``p1``, ``p`` (B, prenet: each prenet layer's output), ``q`` (B, A),
    ``energy`` (B, Tp) and the step's output ``y`` (B, n_mels + 1): the
    frame and the stop logit; fp32; and ``bar``, the kernel's grid barrier
    (two int32 words, zero at first)."""

    def __init__(self, packed: dict, b: int, tp: int, device):
        w = widths(packed)
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
        self.b, self.tp = b, tp
        self.h1, self.c1 = z(2, b, w["h1"]), z(b, w["h1"])
        self.h2, self.c2 = z(2, b, w["h2"]), z(b, w["h2"])
        self.alpha, self.alpha_cum, self.ctx = z(b, tp), z(b, tp), z(b, w["enc"])
        self.p1, self.p = z(b, w["prenet"]), z(b, w["prenet"])
        self.q, self.energy = z(b, w["att"]), z(b, tp)
        self.y = z(b, w["n_mels"] + 1)
        self.bar = torch.zeros(2, dtype=torch.int32, device=device)


def _lstm(gates: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    i, f, g, o = gates.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


@torch.no_grad()
def tacotron2_step_reference(t: int, frame, state: Tacotron2State, memory, pm, lens, packed,
                             prenet_dropout: float = 0.0, seed: int = 0, row0: int = 0):
    """Plain PyTorch version of the kernel, op for op: the step at position
    t from the previous frame (B, n_mels) fp32, over ``memory`` (B, Tp, E)
    and ``pm`` (B, Tp, A) in ``dtype`` and the rows' lengths (B,) int.
    Updates ``state`` as the kernel does and returns ``state.y``."""
    dtype = packed["pw1"].dtype
    w = widths(packed)
    s, b = state, frame.shape[0]

    def dot(a, m):
        return a.to(dtype).float() @ m.float().t()

    threshold, keep_scale = prenet_drop_args(prenet_dropout)
    x = frame.float()
    for layer, m in enumerate((packed["pw1"], packed["pw2"])):
        x = torch.relu(dot(x, m))
        if threshold:
            keep = prenet_keep(t, layer, b, w["prenet"], prenet_dropout, seed, row0, x.device)
            x = torch.where(keep, x * keep_scale, torch.zeros_like(x))
        (s.p1, s.p)[layer].copy_(x)
    cur, nxt = t & 1, (t + 1) & 1
    h1, s.c1[:] = _lstm(dot(torch.cat([x, s.ctx, s.h1[cur]], -1), packed["w1"]) + packed["b1"],
                        s.c1)
    s.h1[nxt] = h1
    s.q.copy_(dot(h1, packed["wq"]))
    k = w["loc_k"]
    f = F.conv1d(torch.stack([s.alpha, s.alpha_cum], 1), packed["wloc"].reshape(w["att"], 2, k),
                 padding=(k - 1) // 2)  # (B, A, Tp)
    z = torch.tanh(s.q[:, :, None] + f + pm.float().transpose(1, 2))
    valid = torch.arange(s.tp, device=frame.device)[None, :] < lens[:, None].long()
    e = torch.where(valid, (packed["v"][None, :, None] * z).sum(1), float("-inf"))
    s.energy.copy_(e)
    ex = torch.where(valid, torch.exp(e - e.max(1, keepdim=True).values), 0.0)
    alpha = ex / ex.sum(1, keepdim=True)
    s.alpha.copy_(alpha)
    s.alpha_cum += alpha
    s.ctx.copy_(torch.einsum("bj,bjd->bd", alpha, memory.float()))
    h2, s.c2[:] = _lstm(dot(torch.cat([h1, s.ctx, s.h2[cur]], -1), packed["w2"]) + packed["b2"],
                        s.c2)
    s.h2[nxt] = h2
    s.y.copy_(dot(torch.cat([h2, s.ctx], -1), packed["wp"]) + packed["bp"])
    return s.y


# ------------------------------------------------------------- the launch

class Tacotron2Prep(NamedTuple):
    """What a ``Tacotron2Step`` needs that depends only on the packed
    weights and the shape (B, Tp): the sizes, the weights' pointers and the
    shared memory of each stage (``prepare_tacotron2``)."""

    shape: tuple  # (B, Tp)
    widths: dict
    pointers: tuple
    smem: tuple  # bytes: prenet layers, lstm 1, query, energy, context, lstm 2, projection


def stage_smem(w: dict, b: int, tp: int) -> tuple:
    """Dynamic shared memory of each launch of a step, in bytes."""
    k = w["loc_k"]
    energy = 4 * (w["att"] * (2 * k + 1) + 2 * (ENERGY_POSITIONS + k - 1) + 2 * w["att"]
                  + ENERGY_POSITIONS * w["att"])
    return (2 * b * max(w["n_mels"], w["prenet"]),
            2 * b * (w["prenet"] + w["enc"] + w["h1"]),
            2 * b * w["h1"],
            energy,
            4 * (tp + CONTEXT_GROUPS * CONTEXT_COLS),
            2 * b * (w["h1"] + w["enc"] + w["h2"]),
            2 * b * (w["h2"] + w["enc"]))


def prepare_tacotron2(packed: dict, b: int, tp: int) -> Tacotron2Prep:
    """The ``Tacotron2Prep`` of b rows over tp encoder positions; raises for
    what the kernel cannot take."""
    w = widths(packed)
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"tacotron2_step takes 1..{MAX_BATCH} rows, got {b}")
    if not 1 <= tp <= MAX_TP:
        raise ValueError(f"tacotron2_step takes 1..{MAX_TP} encoder positions, got {tp}")
    for name in ("n_mels", "prenet", "h1", "h2", "enc"):
        if w[name] % 8:
            raise ValueError(f"tacotron2_step needs widths in multiples of 8: {name}={w[name]}")
    if w["att"] % 2:
        raise ValueError(f"tacotron2_step needs an even attention_dim, got {w['att']}")
    if packed["pw1"].dtype != torch.bfloat16:
        raise ValueError("tacotron2_step takes bf16 weights (runtime.compute_dtype bfloat16)")
    smem = stage_smem(w, b, tp)
    if max(smem) > SMEM_LIMIT:
        raise ValueError(f"tacotron2_step: a stage needs {max(smem)} bytes of shared memory")
    return Tacotron2Prep((b, tp), w, tuple(packed[k].data_ptr() for k in _WEIGHTS), smem)


class _Args(ctypes.Structure):
    """The CUDA source's ``Args``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _WEIGHTS + ("memory", "pm", "lens") + _STATE]
                + [(n, ctypes.c_int) for n in ("b", "tp", "n_mels", "prenet", "h1d", "h2d",
                                               "enc", "att", "loc_k")]
                + [("smem", ctypes.c_int * 7)])


def _lib():
    from transformertts_tpu_torch import _build

    lib = _build.load("tacotron2_step")
    if not getattr(lib, "_argtypes_set", False):
        i, p, u = ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32
        ll, f = ctypes.c_longlong, ctypes.c_float
        lib.tacotron2_step.argtypes = [p, p, ll, i, u, u, f, i, p, ll, p, ll, p, f, p]
        lib.tacotron2_step.restype = i
        lib.tacotron2_step_args_bytes.restype = ctypes.c_long
        if lib.tacotron2_step_args_bytes() != ctypes.sizeof(_Args):
            raise RuntimeError("tacotron2_step: _Args does not mirror the CUDA Args")
        lib._argtypes_set = True
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device or not t.is_contiguous():
        raise ValueError(f"tacotron2_step: {name} must be a contiguous {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


class Tacotron2Step:
    """The decoder step of b rows on the GPU, prepared for one decode's
    encoder memory and state.  Each call is one C call that launches the
    step's kernel on the current stream:

        step = Tacotron2Step(memory, pm, lens, packed, state[, prep])
        y = step(t, frame)  # state.y: (B, n_mels + 1), the frame and the stop logit

    ``frame`` (B, n_mels) fp32 may have a row stride (a column of the
    decode's frame buffer).  ``launches`` counts this step's calls, one
    kernel launch each (each also adds to ``Tacotron2Step.total``)."""

    total = 0

    def __init__(self, memory, pm, lens, packed, state: Tacotron2State,
                 prep: Tacotron2Prep | None = None):
        b, tp, _ = memory.shape
        prep = prep or prepare_tacotron2(packed, b, tp)
        if prep.shape != (b, tp):
            raise ValueError(f"tacotron2_step: a step prepared for (B, Tp) {prep.shape} cannot "
                             f"take {(b, tp)}")
        w, dev = prep.widths, memory.device
        _check("memory", memory, (b, tp, w["enc"]), torch.bfloat16, dev)
        _check("pm", pm, (b, tp, w["att"]), torch.bfloat16, dev)
        _check("lens", lens, (b,), torch.int32, dev)
        self._keep = (memory, pm, lens, packed, state)  # the pointers stay valid
        self._args = _Args(
            *prep.pointers, memory.data_ptr(), pm.data_ptr(), lens.data_ptr(),
            *[getattr(state, n).data_ptr() for n in _STATE],
            b, tp, w["n_mels"], w["prenet"], w["h1"], w["h2"], w["enc"], w["att"], w["loc_k"],
            (ctypes.c_int * 7)(*prep.smem))
        self._call = _lib().tacotron2_step
        self.state, self.b, self.n_mels = state, b, w["n_mels"]
        self.launches = 0

    def __call__(self, t: int, frame, prenet_dropout: float = 0.0, seed: int = 0,
                 row0: int = 0, emit: tuple | None = None) -> torch.Tensor:
        """The step at position ``t``.  ``emit``: (frames (B, n_mels) fp32,
        stops (B,) fp32, stopped (B,) bool, stop threshold) into which the
        kernel also writes the frame, the stop logit and or's the stop vote
        ``sigmoid(logit) >= threshold`` of each row."""
        if frame.dtype != torch.float32 or tuple(frame.shape) != (self.b, self.n_mels) or (
                frame.stride(1) != 1 or frame.stride(0) % 4 or frame.data_ptr() % 16):
            raise ValueError(f"tacotron2_step: frame must be fp32 ({self.b}, {self.n_mels}), "
                             "16-byte aligned, rows a multiple of 4 floats apart, got "
                             f"{frame.dtype} {tuple(frame.shape)} strides {frame.stride()}")
        threshold, keep_scale = prenet_drop_args(prenet_dropout)
        out = (None, 0, None, 0, None, 0.0)
        if emit is not None:
            frames, stops, stopped, stop_threshold = emit
            if (frames.dtype != torch.float32 or tuple(frames.shape) != (self.b, self.n_mels)
                    or frames.stride(1) != 1 or stops.dtype != torch.float32
                    or tuple(stops.shape) != (self.b,) or stopped.dtype != torch.bool
                    or tuple(stopped.shape) != (self.b,) or stopped.stride(0) != 1):
                raise ValueError("tacotron2_step: emit takes frames (B, n_mels) fp32, stops (B,) "
                                 "fp32 and stopped (B,) bool with unit strides")
            out = (frames.data_ptr(), frames.stride(0), stops.data_ptr(), stops.stride(0),
                   stopped.data_ptr(), float(stop_threshold))
        rc = self._call(ctypes.byref(self._args), frame.data_ptr(), frame.stride(0), int(t),
                        int(seed) & 0xFFFFFFFF, threshold, keep_scale, int(row0), *out,
                        torch.cuda.current_stream(frame.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"tacotron2_step kernels refused or failed to launch (CUDA error "
                               f"{rc}) for B={self.b}, Tp={self._args.tp}, t={t}")
        self.launches += 1
        Tacotron2Step.total += 1
        return self.state.y
