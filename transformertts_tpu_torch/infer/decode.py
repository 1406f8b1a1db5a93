"""KV-cached autoregressive greedy mel decoding (``transformertts_tpu/infer/decode.py``).

Two loops with one result:

- the plain loop mirrors the JAX XLA loop (``decode.py:191-302``): the
  encoder runs unmasked (the reference's quirk, model/model.py:345-348),
  cross-attention K/V are built once, the self-attention caches grow by one
  row per step, a row stops voting when ``sigmoid(stop) >= threshold`` and
  the loop ends when every row has voted or at ``max_len``;
- the kernel loop mirrors ``_megakernel_decode(_batched)``
  (``decode.py:522-685``): each step is ONE launch of the decode-step
  kernel on the GPU, through an ``ops.decode_step.DecodeStep`` made once
  per chunk of rows (checks, buffers) from what ``DecodeWeights`` keeps
  per shape (packed weights, PE rows, plan and its tables), so a step
  costs the host one C call.  A batch larger than the kernel takes is
  decoded as consecutive chunks of rows.

Both are one ``DecodeState``: the encoder's output, the frame buffer, the
stop logits and votes, and per chunk of rows (``DecodeRows``) its caches,
its window center and, on the GPU, its prepared step.  The one-shot decode
(``make_decode_fn``) advances each chunk to its own stop (``run_each``);
the stream (``infer/streaming.py``) advances every chunk in lockstep, a
chunk of positions at a time (``run_lockstep``).  The step bodies exist
once, in ``PlainRows.body`` and ``KernelRows.body``.

On the GPU the kernel loop is the decode path; the plain loop runs there
only when the caller asks for it by name (``use_kernel=False``), as a
reference to hold the kernel loop against.

Both keep the windowed monotone cross-attention (``decode_attn_window``
W > 0): every layer's cross-attention sees only encoder positions within
``[center - W, center + W]``, and the center follows the last layer's
head-averaged expected position, only ever forward.  With reduction factor
r > 1 each step emits r frames and feeds back the last one.  With
``runtime.infer_prenet_dropout`` > 0 both drop prenet elements (JAX
``_prenet_dropout_step``): the plain loop by ``prenet_dropout_step``, the
kernel loop inside the kernel, with the same counter-hash masks
(``ops.decode_step.prenet_keep``; seed ``training.seed ^ 0x5EED`` as the
JAX loop's key).

The loop runs in Python and reads the stop votes back ``LAG`` steps late
(``StopVotes``): each step writes its votes into its own row of a vote
history on the device, and every ``LAG`` steps the loop copies the rows
just written to pinned host memory without waiting and waits on the copy
of ``LAG`` steps earlier, so the host queues steps up to 2 ``LAG`` ahead
of the device and the device does not wait for the host's readback.  The
first step after which every row had voted is found exactly, from the
votes as the steps cast them (never recomputed from the stop logits); the
steps launched past it are rolled back (their frames zero, their stop
logits ``NEG_INF``, ``t`` set back), so the result is that of a loop that
reads the votes back before every step.

Spans (``utils/trace.py``): ``decode.init`` (``DecodeState`` and
``SpeculativeDecode`` set-up) holds ``decode.encode``, ``decode.cross_kv``
and one ``decode.plan`` per chunk of rows (``KernelRows`` or ``PlainRows``:
the permuted cross K/V, the caches and the ``DecodeStep``; a kernel loop's
carries ``hit``: its shape's PE rows and step preparation were kept);
``decode.loop`` is one call of ``run_each``, ``run_lockstep`` or
``SpeculativeDecode.run`` with ``steps`` (the steps kept, as ``n_steps``
counts them), ``waits`` (the host's blocking waits for the votes: about
one per ``LAG`` steps, one per pass of ``SpeculativeDecode``),
``overrun`` (steps launched past the stop and rolled back) and
``readback_ns`` (the host's time inside those waits: the rest of the loop
is host work); under a running profiler each step is a ``decode.step``
range as well.  ``decode.postnet`` is the postnet and the rows' lengths of
the result.

A Tacotron 2 model (``model.architecture`` tacotron2, ``models/tacotron2.py``)
decodes through the same ``DecodeState``: its rows carry a recurrent state
of fixed size (both LSTM cells, the attention weights and their running
sum, the context) in place of a growing cache, ``T2PlainRows`` through the
model's modules and ``T2KernelRows`` through ``ops/tacotron2_step.py`` (one
C call and one launch a step on the GPU); ``decode.init`` holds ``decode.encode`` (the
convolutions and the BiLSTM over each row's length) and ``decode.memory``
(``W_mem memory``) in place of ``decode.cross_kv``.  Its prenet always
drops at ``runtime.infer_prenet_dropout`` (the stream too), and speculative
decode and the window raise.

Speculative decode (``runtime.decode_speculative_k`` K > 1, one utterance:
JAX ``_speculative_decode``) is ``SpeculativeDecode``: each pass drafts K -
1 inputs, verifies the K positions at once and advances by the accepted
groups, reading back one integer a pass; on the GPU a pass is one launch of
the verify kernel (``ops.decode_step.DecodeVerify``), which also drafts,
accepts and writes the frames.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from transformertts_tpu_torch.config import Config
from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.models.factory import is_tacotron2
from transformertts_tpu_torch.models.masks import NEG_INF, padding_bias
from transformertts_tpu_torch.models.tts import shift_right
from transformertts_tpu_torch.ops.decode_step import (
    MAX_BATCH,
    DecodeStep,
    DecodeVerify,
    accept_reference,
    decode_step,
    draft_frames,
    pack_decode_weights,
    pack_verify_weights,
    prenet_drop_args,
    prenet_keep,
    prepare_step,
)
from transformertts_tpu_torch.ops.tacotron2_step import (
    Tacotron2State,
    Tacotron2Step,
    pack_tacotron2_weights,
    prepare_tacotron2,
    tacotron2_step_reference,
)
from transformertts_tpu_torch.utils import trace


def per_row_lengths(stops: torch.Tensor, n_frames: int, stop_threshold: float) -> torch.Tensor:
    """Frames up to and including each row's own first stop vote, bounded by
    the global stop step (the reference's only cut, model/model.py:382)."""
    voted = torch.sigmoid(stops) >= stop_threshold
    first = voted.int().argmax(dim=1)  # 0 if no vote
    has_vote = voted.any(dim=1)
    return torch.where(has_vote, first + 1, torch.full_like(first, n_frames)).int()


def _window_bias(center: torch.Tensor, tp: int, w: int) -> torch.Tensor:
    """(B, Tp) bias: NEG_INF outside [center - w, center + w]."""
    pos = torch.arange(tp, dtype=torch.float32, device=center.device)[None, :]
    c = center[:, None]
    inside = (pos >= c - w) & (pos <= c + w)
    return torch.where(inside, 0.0, NEG_INF)


def prenet_seed(cfg: Config) -> int:
    """Seed of the inference prenet-dropout masks (the JAX loop's
    ``PRNGKey(training.seed ^ 0x5EED)``)."""
    return int(cfg.training.seed) ^ 0x5EED


def prenet_dropout_step(model, frame, t: int, rate: float, seed: int, row0: int = 0,
                        keep=None) -> torch.Tensor:
    """Decoder prenet with live dropout, then ``+ alpha * PE[t]`` (JAX
    ``_prenet_dropout_step``): (B, 1, n_mels) -> (B, 1, D) in the model's
    dtype.  Each layer's ReLU output keeps an element where its mask is
    True, scaled by ``1 / (1 - rate)``, and is 0 elsewhere; the PE is added
    in fp32 to the dropped activation.  ``keep``: (2, B, 1, D) bool masks
    of the two layers; None takes ``prenet_keep``'s for rows ``row0 ..``."""
    pn, dtype = model.dec_prenet, model.dtype
    _, keep_scale = prenet_drop_args(rate)
    x = frame.to(dtype)
    for i, layer in enumerate((pn.LinearNorm_0, pn.LinearNorm_1)):
        x = torch.relu(layer(x))
        k = keep[i] if keep is not None else prenet_keep(
            t, i, x.shape[0], x.shape[-1], rate, seed, row0, x.device)[:, None, :]
        x = torch.where(k, x * keep_scale, torch.zeros_like(x))
    pe_row = model.pe.pe[t: t + 1]
    return (x.float() + model.pe.alpha.float() * pe_row).to(dtype)


def kernel_cross_kv(cross_kv) -> tuple:
    """The cross-attention K and V, L x ((B, Tp, H, dh) x 2), in the
    kernels' layout: two (L, H, B, Tp, dh) tensors."""
    return tuple(torch.stack([kv[i] for kv in cross_kv]).permute(0, 3, 1, 2, 4).contiguous()
                 for i in (0, 1))


LAG = 8  # steps between the decode loop's waits for the stop votes


class StopVotes:
    """A decode's stop votes, read back ``LAG`` steps late.

    ``votes`` (n_pos, B) bool on the decode's device: each step writes its
    rows' votes into its own row (the step at position t into row t).  Every
    ``LAG`` steps ``run`` copies the rows just written into ``host``, their
    copy in pinned memory, without waiting, records an event, waits on the
    one recorded ``LAG`` steps before and reads the rows that event covers,
    oldest first, or-ing each into ``voted``: the first step after which
    every row has voted is the stop.  So the host runs at most 2 ``LAG``
    steps ahead of the device and the device has steps queued while the
    host waits.  At the loop's end one more wait reads the rows still
    pending.  On the CPU the copies are synchronous and there are no
    events.

    ``voted``: each row's votes or-ed over the steps the loops kept, the
    state the next loop starts from (the check before its first step).
    Made once per ``DecodeState`` (``host`` from the caching host allocator:
    no ``cudaHostAlloc`` per request) and used by one thread."""

    def __init__(self, n_pos: int, b: int, device: torch.device):
        self.lag, self.device = LAG, device
        cuda = device.type == "cuda"
        self.votes = torch.zeros((n_pos, b), dtype=torch.bool, device=device)
        self.host = torch.empty((n_pos, b), dtype=torch.bool, pin_memory=cuda)
        self.host_np = self.host.numpy()
        self.voted = np.zeros(b, dtype=bool)
        self.events = [torch.cuda.Event() for _ in range(3)] if cuda else None

    def _copy(self, first: int, end: int, event: int) -> None:
        """Rows ``first .. end - 1`` to the host, then event ``event``."""
        self.host[first:end].copy_(self.votes[first:end], non_blocking=True)
        if self.events is not None:
            self.events[event].record(torch.cuda.current_stream(self.device))

    def _wait(self, event: int) -> int:
        """Waits on event ``event``; returns the nanoseconds waited."""
        if self.events is None:
            return 0
        t0 = time.perf_counter_ns()
        self.events[event].synchronize()
        return time.perf_counter_ns() - t0

    def _read(self, rows: slice, first: int, end: int) -> Optional[int]:
        """Or's the votes of positions ``first .. end - 1`` into ``voted``
        of ``rows``, in turn, up to the first position after which every
        row had voted: returns that position, else None."""
        if first >= end:
            return None
        seen = np.logical_or.accumulate(self.host_np[first:end, rows], axis=0) | self.voted[rows]
        done = seen.all(axis=1)
        at = int(done.argmax()) if done.any() else end - first - 1
        self.voted[rows] = seen[at]
        return first + at if done[at] else None

    def run(self, rows: slice, t: int, n: int, step) -> tuple:
        """Calls ``step()`` (the steps at positions t, t + 1, ...) at most n
        times while some row of ``rows`` has not voted; returns (steps kept,
        steps run, waits, nanoseconds waited).  The steps kept are those a
        loop that read the votes before every step runs: up to the first
        after which every row had voted.  The caller rolls back the rest.
        Under a running profiler each step is a ``decode.step`` range."""
        if n <= 0 or self.voted[rows].all():
            return 0, 0, 0, 0
        lag, ranged = self.lag, trace.profiling()
        ran = read = waits = waited = 0
        stop = None
        while ran < n and stop is None:
            if ranged:
                with trace.step_range("decode.step"):
                    step()
            else:
                step()
            ran += 1
            if ran % lag == 0:
                mark = ran // lag  # the votes up to step ran - lag are in at mark - 1's event
                self._copy(t + ran - lag, t + ran, mark % 2)
                if mark > 1:
                    waited += self._wait((mark - 1) % 2)
                    waits += 1
                    stop = self._read(rows, t + read, t + ran - lag)
                    read = ran - lag
        if stop is None:
            self._copy(t + ran - ran % lag, t + ran, 2)
            waited += self._wait(2)
            waits += 1
            stop = self._read(rows, t + read, t + ran)
        return (ran if stop is None else stop - t + 1), ran, waits, waited


class DecodeRows:
    """One chunk of rows of a ``DecodeState``: the step body and what only
    this chunk's steps read (caches, window center).  ``frames``, ``stops``
    and ``votes`` (``StopVotes.votes``: row t the votes of the step at t)
    are views of the whole state's buffers; ``row0`` is the chunk's first
    row in the batch."""

    def __init__(self, model, cfg, frames, stops, votes, cross_kv, cross_bias, n_pos,
                 stop_threshold, row0, prenet_dropout):
        m = cfg.model
        self.model, self.r, self.n_mels = model, m.reduction_factor, m.n_mels
        self.frames, self.stops, self.votes = frames, stops, votes
        self.cross_kv, self.cross_bias = cross_kv, cross_bias
        self.n_pos, self.stop_threshold = n_pos, stop_threshold
        self.attn_win = int(cfg.runtime.decode_attn_window)
        self.row0, self.prenet_dropout, self.seed = row0, float(prenet_dropout), prenet_seed(cfg)
        self.b, self.tp = cross_bias.shape[0], cross_bias.shape[-1]
        self.center = torch.zeros((self.b,), dtype=torch.float32, device=cross_bias.device)
        self.t = 0

    def body(self, t: int):
        """The step at position t: (mel (B, r, n_mels) fp32, stop (B, r)
        fp32, the last layer's expected attention position (B,) or None)."""
        raise NotImplementedError

    def step(self) -> None:
        """Run the step at position ``t`` and advance ``t``."""
        t, r = self.t, self.r
        mel_t, stop_t, exp_pos = self.body(t)
        self.frames[:, t * r + 1: t * r + 1 + r] = mel_t
        self.stops[:, t * r: t * r + r] = stop_t
        torch.any(torch.sigmoid(stop_t) >= self.stop_threshold, dim=1, out=self.votes[t])
        if exp_pos is not None:
            self.center = torch.maximum(self.center, exp_pos)
        self.t += 1

    def roll_back(self, t: int) -> None:
        """Takes back the steps at positions ``t`` on, run past the stop:
        their frames zero again and their stop logits ``NEG_INF``, as if
        never run, and ``t`` the position reached.  What else they wrote
        (caches, window center, recurrent state) is dead: no caller resumes
        a loop past its stop."""
        r, end = self.r, self.t
        if t < end:
            self.frames[:, t * r + 1: end * r + 1] = 0.0
            self.stops[:, t * r: end * r] = NEG_INF
            self.t = t


class PlainRows(DecodeRows):
    """The XLA loop of the JAX package, step by step in PyTorch ops."""

    def __init__(self, *args):
        super().__init__(*args)
        m = self.model.cfg
        shape = (m.decoder_n_layers, self.b, self.n_pos, m.decoder_n_head,
                 m.d_model // m.decoder_n_head)
        dev = self.cross_bias.device
        self.self_k = torch.zeros(shape, dtype=self.model.dtype, device=dev)
        self.self_v = torch.zeros(shape, dtype=self.model.dtype, device=dev)
        self.pos_f = torch.arange(self.tp, dtype=torch.float32, device=dev)[None, :]

    def body(self, t):
        model, r, attn_win, n_pos = self.model, self.r, self.attn_win, self.n_pos
        frame = self.frames[:, t * r: t * r + 1]
        if self.prenet_dropout > 0.0:
            x = prenet_dropout_step(model, frame, t, self.prenet_dropout, self.seed, self.row0)
        else:
            x = model.prenet_step(frame, t)  # (B, 1, D)
        cb = self.cross_bias
        if attn_win > 0:
            cb = cb + _window_bias(self.center, self.tp, attn_win)[:, None, None, :]
        self_bias = torch.where(
            torch.arange(n_pos, device=frame.device) <= t, 0.0, NEG_INF
        )[None, None, None, :]
        layers = model.decoder.layers
        attn_w = None
        for li, layer in enumerate(layers):
            k_new, v_new = layer.project_self_kv(x)  # (B, 1, H, dh)
            self.self_k[li, :, t] = k_new[:, 0]
            self.self_v[li, :, t] = v_new[:, 0]
            ck, cv = self.cross_kv[li]
            if attn_win > 0 and li == len(layers) - 1:
                x, attn_w = layer.cached_step_attn(
                    x, self.self_k[li], self.self_v[li], ck, cv, self_bias, cb)
            else:
                x = layer.cached_step(x, self.self_k[li], self.self_v[li], ck, cv, self_bias, cb)
        mel_t, stop_t = model.decode_frame_heads(x)  # (B, r, C), (B, r)
        exp_pos = None
        if attn_win > 0:
            w = attn_w.float().mean(dim=1)[:, 0, :]  # (B, Tp), head mean
            exp_pos = (w * self.pos_f).sum(1) / torch.clamp(w.sum(1), min=1e-6)
        return mel_t.float(), stop_t.float(), exp_pos


class KernelRows(DecodeRows):
    """One decode-step launch per step (the megakernel loops of the JAX
    package); caches in the kernel's (L, H, B, T, dh) layout.  On the GPU
    the step is a ``DecodeStep`` made here from what ``weights``
    (``DecodeWeights``) keeps for this shape; on the CPU ``decode_step``'s
    plain version.  ``hit``: the shape's preparation came from the cache."""

    def __init__(self, *args, weights):
        super().__init__(*args)
        model, m = self.model, self.model.cfg
        dev = self.cross_bias.device
        packed, self.pe_table, prep, self.hit = weights.prepared(self.b, self.n_pos, self.tp, dev)
        ck, cv = kernel_cross_kv(self.cross_kv)
        self.cbias = self.cross_bias[:, 0, 0, :].float().contiguous()  # (B, Tp)
        shape = (m.decoder_n_layers, m.decoder_n_head, self.b, self.n_pos,
                 m.d_model // m.decoder_n_head)
        self_k = torch.zeros(shape, dtype=model.dtype, device=dev)
        self_v = torch.zeros(shape, dtype=model.dtype, device=dev)
        with_pos = self.attn_win > 0
        if dev.type == "cuda":
            self.decode_step = DecodeStep(self_k, self_v, ck, cv, packed, with_attn_pos=with_pos,
                                          prep=prep)
            self._step = self.decode_step
        else:
            self.decode_step = None

            def step(t, frame, pe_row, cb, **drop):
                return decode_step(t, frame, pe_row, cb, self_k, self_v, ck, cv, packed,
                                   with_attn_pos=with_pos, **drop)
            self._step = step

    def body(self, t):
        r, n_mels, b = self.r, self.n_mels, self.b
        frame = self.frames[:, t * r]  # (B, n_mels), rows apart in the frame buffer
        pe_row = self.pe_table[t: t + 1]
        cb_t = self.cbias
        if self.attn_win > 0:
            cb_t = (self.cbias + _window_bias(self.center, self.tp, self.attn_win)).contiguous()
        out = self._step(t, frame, pe_row, cb_t, prenet_dropout=self.prenet_dropout,
                         seed=self.seed, row0=self.row0)
        y = out[0]
        exp_pos = out[3][:, 0] if self.attn_win > 0 else None
        return y[:, : n_mels * r].reshape(b, r, n_mels), y[:, n_mels * r:], exp_pos


class T2PlainRows(DecodeRows):
    """Tacotron 2's step through the model's modules (``Tacotron2.decoder_step``):
    the recurrent state of ``initial_state`` in place of a cache.
    ``cross_kv`` is [(memory, processed memory)] of the chunk's rows."""

    def __init__(self, *args):
        super().__init__(*args)
        (self.memory, self.pm), = self.cross_kv
        self.valid = self.cross_bias[:, 0, 0, :] == 0
        self.state = self.model.initial_state(self.b, self.tp)
        self.keep_scale = prenet_drop_args(self.prenet_dropout)[1]

    def body(self, t):
        keep = None
        if self.prenet_dropout > 0.0:
            p = self.model.cfg.prenet_dim
            keep = ([prenet_keep(t, i, self.b, p, self.prenet_dropout, self.seed, self.row0,
                                 self.memory.device) for i in (0, 1)], self.keep_scale)
        mel, stop, _ = self.model.decoder_step(self.frames[:, t], self.state, self.memory,
                                               self.pm, self.valid, keep)
        return mel[:, None, :], stop[:, None], None


class T2KernelRows(DecodeRows):
    """Tacotron 2's step as ``ops.tacotron2_step``: on the GPU a
    ``Tacotron2Step`` made here from what ``weights`` keeps for this shape
    (one C call a step), on the CPU ``tacotron2_step_reference``; the state
    is a ``Tacotron2State``.  ``hit``: the shape's preparation came from the
    cache."""

    def __init__(self, *args, weights):
        super().__init__(*args)
        (memory, pm), = self.cross_kv
        dev = memory.device
        packed, _, prep, self.hit = weights.prepared(self.b, self.n_pos, self.tp, dev)
        lens = (self.cross_bias[:, 0, 0, :] == 0).sum(1).int()
        self.state = Tacotron2State(packed, self.b, self.tp, dev)
        if dev.type == "cuda":
            self._step = Tacotron2Step(memory.contiguous(), pm.contiguous(), lens, packed,
                                       self.state, prep)
        else:
            def step(t, frame, **drop):
                return tacotron2_step_reference(t, frame, self.state, memory, pm, lens, packed,
                                                **drop)
            self._step = step

    def body(self, t):
        y = self._step(t, self.frames[:, t], prenet_dropout=self.prenet_dropout, seed=self.seed,
                       row0=self.row0)
        return y[:, None, : self.n_mels], y[:, self.n_mels:], None

    def step(self) -> None:
        """On the GPU the kernel also writes the frame and the stop logit into
        the decode's buffers and the stop vote into ``votes`` (the
        shared step's writes, without their launches and their host work);
        on the CPU the shared step."""
        if not isinstance(self._step, Tacotron2Step):
            return super().step()
        t = self.t
        self._step(t, self.frames[:, t], prenet_dropout=self.prenet_dropout, seed=self.seed,
                   row0=self.row0, emit=(self.frames[:, t + 1], self.stops[:, t], self.votes[t],
                                         self.stop_threshold))
        self.t = t + 1


class DecodeState:
    """The state of one decode of a batch: the buffers every chunk of rows
    writes (``frames`` (B, max_len + 1, n_mels) fp32 with the go frame at
    0, ``stops`` (B, max_len), ``votes``, a ``StopVotes``) and the chunks
    (``rows``): one ``PlainRows`` for the plain loop, ``KernelRows`` of at
    most ``chunk`` rows each for the kernel loop, made from ``weights``
    (``DecodeWeights``).  Each chunk's ``decode.plan`` span of the kernel
    loop carries ``hit``: its shape's preparation came from the cache."""

    def __init__(self, model, cfg, phoneme, lens, max_len, stop_threshold, kernel, weights,
                 chunk, prenet_dropout, mask_encoder_source=False):
        b, tp = phoneme.shape
        dev, n_mels = phoneme.device, cfg.model.n_mels
        self.n_pos = max_len // cfg.model.reduction_factor
        t2 = is_tacotron2(model)
        with trace.span("decode.init"):
            with trace.span("decode.encode"):
                memory = model.encode(phoneme, lens if mask_encoder_source or t2 else None)
            if t2:
                with trace.span("decode.memory"):
                    cross_kv = [(memory, model.process_memory(memory))]  # the rows' (K, V)
                    cross_bias = padding_bias(lens, tp)
                plain, kernel_rows = T2PlainRows, T2KernelRows
            else:
                with trace.span("decode.cross_kv"):
                    cross_kv = model.build_cross_cache(memory)  # L x ((B, Tp, H, dh) x 2)
                    cross_bias = padding_bias(lens, tp)  # (B, 1, 1, Tp)
                plain, kernel_rows = PlainRows, KernelRows
            self.frames = torch.zeros((b, max_len + 1, n_mels), dtype=torch.float32, device=dev)
            self.stops = torch.full((b, max_len), NEG_INF, dtype=torch.float32, device=dev)
            self.votes = StopVotes(self.n_pos, b, dev)
            step = chunk if kernel else b
            self.rows = []
            for i in range(0, b, step):
                part = slice(i, i + step)
                args = (model, cfg, self.frames[part], self.stops[part], self.votes.votes[:, part],
                        [(k[part], v[part]) for k, v in cross_kv], cross_bias[part],
                        self.n_pos, stop_threshold, i, prenet_dropout)
                with trace.span("decode.plan", rows=min(step, b - i)) as s:
                    if kernel:
                        self.rows.append(kernel_rows(*args, weights=weights))
                        s.attrs["hit"] = self.rows[-1].hit
                    else:
                        self.rows.append(plain(*args))

    @property
    def t(self) -> int:
        """Positions decoded: the furthest chunk's."""
        return max(rows.t for rows in self.rows)

    @property
    def n_steps(self) -> int:
        """Steps run, summed over the chunks (kernel launches on the GPU)."""
        return sum(rows.t for rows in self.rows)

    def _run(self, rows: slice, chunks: list, until: int, step, attrs: dict) -> None:
        """``votes.run`` from the chunks' position to ``until``, then the
        chunks rolled back to the stop; adds to the span's counters
        (``overrun`` summed over the chunks, as ``steps``)."""
        t = chunks[0].t
        kept, ran, waits, waited = self.votes.run(rows, t, until - t, step)
        for chunk in chunks:
            chunk.roll_back(t + kept)
        attrs["waits"] += waits
        attrs["overrun"] += (ran - kept) * len(chunks)
        attrs["readback_ns"] += waited

    def run_each(self, until: int) -> None:
        """Each chunk to position ``until`` or its own rows' votes, in turn."""
        with trace.span("decode.loop", waits=0, overrun=0, readback_ns=0) as s:
            before = self.n_steps
            for rows in self.rows:
                self._run(slice(rows.row0, rows.row0 + rows.b), [rows], until, rows.step,
                          s.attrs)
            s.attrs["steps"] = self.n_steps - before

    def run_lockstep(self, until: int) -> None:
        """Every chunk takes each step, until position ``until`` or until
        every row of the batch has voted (the JAX stream's global stop)."""
        def step() -> None:
            for rows in self.rows:
                rows.step()

        with trace.span("decode.loop", waits=0, overrun=0, readback_ns=0) as s:
            before = self.n_steps
            self._run(slice(None), self.rows, until, step, s.attrs)
            s.attrs["steps"] = self.n_steps - before


class SpeculativeDecode:
    """The draft-and-verify decode of one utterance (JAX
    ``_speculative_decode``, ``transformertts_tpu/infer/decode.py:307-457``).

    Each pass drafts the next K - 1 decoder inputs from the frame buffer
    (``"linear"``: f0 + j (f0 - prev); ``"hold"``: f0), runs the decoder once
    over the K positions t .. t + K - 1 (row j writes its K/V at t + j and
    attends to positions <= t + j), accepts the leading run of drafts within
    ``decode_speculative_tau`` of the previous group's last frame (cut at
    the first group with a stop vote and at n_pos), writes the accepted m
    groups' frames and stop logits and advances t by m >= 1.  Row 0's input
    is the true frame, so tau = 0 decodes as the sequential loop does, one
    group a pass.  The pass's result, 2 m + vote, is read back once a pass.

    The kernel loop runs each pass as ONE launch of the verify kernel
    (``ops.decode_step.DecodeVerify``; its plain version on the CPU), which
    also drafts, accepts and writes the frames.  The plain loop runs the
    JAX loop's ops through the model's modules (``prenet_step`` over K
    positions, ``project_self_kv``, ``cached_step`` with the per-row causal
    bias, ``decode_frame_heads``) and ``accept_reference``."""

    def __init__(self, model, cfg, phoneme, lens, max_len, stop_threshold, kernel, packed,
                 mask_encoder_source=False, verify_weights=None):
        m, rt = cfg.model, cfg.runtime
        dev, tp = phoneme.device, phoneme.shape[1]
        self.model, self.r, self.n_mels = model, m.reduction_factor, m.n_mels
        self.k, self.n_pos = int(rt.decode_speculative_k), max_len // m.reduction_factor
        self.tau, self.stop_threshold = float(rt.decode_speculative_tau), stop_threshold
        self.linear = rt.decode_speculative_draft == "linear"
        with trace.span("decode.init"):
            with trace.span("decode.encode"):
                memory = model.encode(phoneme, lens if mask_encoder_source else None)
            with trace.span("decode.cross_kv"):
                self.cross_kv = model.build_cross_cache(memory)  # L x ((1, Tp, H, dh) x 2)
                self.cross_bias = padding_bias(lens, tp)  # (1, 1, 1, Tp)
            self.frames = torch.zeros((1, max_len + 1, m.n_mels), dtype=torch.float32,
                                      device=dev)
            self.stops = torch.full((1, max_len), NEG_INF, dtype=torch.float32, device=dev)
            with trace.span("decode.plan", rows=1):
                self._plan(model, m, dev, kernel, packed, stop_threshold, verify_weights)
        self.t = self.passes = 0

    def _plan(self, model, m, dev, kernel, packed, stop_threshold, verify_weights) -> None:
        """The caches and the pass: the verify kernel's, or the plain one's."""
        cap = self.n_pos + self.k  # the chunk's rows past n_pos stay in the caches
        L, H, dh = m.decoder_n_layers, m.decoder_n_head, m.d_model // m.decoder_n_head
        if kernel:
            ck, cv = kernel_cross_kv(self.cross_kv)
            self_k = torch.zeros((L, H, 1, cap, dh), dtype=model.dtype, device=dev)
            self.verify = DecodeVerify(
                self_k, torch.zeros_like(self_k), ck, cv, packed,
                self.cross_bias[:, 0, 0, :].float().contiguous(),
                pe_table(model, self.n_pos + self.k - 1), self.frames[0],
                self.stops[0], k=self.k, r=self.r, n_pos=self.n_pos, tau=self.tau,
                stop_threshold=stop_threshold, linear=self.linear, verify_weights=verify_weights)
            self.pass_ = self.verify
        else:
            self.self_k = torch.zeros((L, 1, cap, H, dh), dtype=model.dtype, device=dev)
            self.self_v = torch.zeros_like(self.self_k)
            self.rows = torch.arange(self.k, device=dev)[:, None]
            self.cols = torch.arange(cap, device=dev)[None, :]
            self.pass_ = self.plain_pass

    def plain_pass(self, t: int) -> int:
        """One pass through the model's modules; returns 2 m + vote."""
        model, r, k, n_mels = self.model, self.r, self.k, self.n_mels
        frames = self.frames[0]
        drafts = draft_frames(frames, t, r, k, self.linear)  # (K, n_mels)
        x = model.prenet_step(drafts[None], t)  # (1, K, D)
        bias = torch.where(self.cols <= t + self.rows, 0.0, NEG_INF)[None, None]  # (1, 1, K, cap)
        for li, layer in enumerate(model.decoder.layers):
            k_new, v_new = layer.project_self_kv(x)  # (1, K, H, dh)
            self.self_k[li, :, t:t + k] = k_new
            self.self_v[li, :, t:t + k] = v_new
            ck, cv = self.cross_kv[li]
            x = layer.cached_step(x, self.self_k[li], self.self_v[li], ck, cv, bias,
                                  self.cross_bias)
        mel, stop = model.decode_frame_heads(x)  # (1, K r, n_mels), (1, K r)
        mel, stop = mel.float().reshape(k, r * n_mels), stop.float().reshape(k, r)
        code = int(accept_reference(mel, stop, drafts, r, self.tau, self.stop_threshold,
                                    self.n_pos - t))
        m = code // 2
        frames[t * r + 1: t * r + 1 + m * r] = mel.reshape(k * r, n_mels)[:m * r]
        self.stops[0, t * r: t * r + m * r] = stop.reshape(-1)[:m * r]
        return code

    def run(self) -> None:
        """Passes until position n_pos or a stop vote."""
        with trace.span("decode.loop") as s:
            stopped, waited, ranged, before = False, 0, trace.profiling(), self.passes
            while self.t < self.n_pos and not stopped:
                if ranged:
                    with trace.step_range("decode.step"):
                        out = self.pass_(self.t)
                else:
                    out = self.pass_(self.t)
                t0 = time.perf_counter_ns()
                code = int(out)  # the pass's one readback
                waited += time.perf_counter_ns() - t0
                self.t += code // 2
                stopped = bool(code & 1)
                self.passes += 1
            s.attrs["readback_ns"] = waited
            s.attrs["steps"] = s.attrs["waits"] = self.passes - before
            s.attrs["overrun"] = 0


def decode_options(cfg: Config, device: torch.device, use_kernel: Optional[bool]) -> tuple:
    """(kernel loop?, rows a kernel call) of a decode on ``device``: the
    kernel loop on CUDA unless ``use_kernel=False`` (and there it needs
    ``use_pallas_decode_step``), the plain loop on the CPU unless
    ``use_kernel=True``."""
    if use_kernel is None and device.type == "cuda" and not cfg.runtime.use_pallas_decode_step:
        raise ValueError(
            "on CUDA the decode runs the decode-step kernel; use_pallas_decode_step=False "
            "has no GPU path (pass use_kernel=False to run the plain reference loop)"
        )
    kernel = use_kernel if use_kernel is not None else device.type == "cuda"
    chunk = min(int(cfg.runtime.decode_megakernel_max_batch), MAX_BATCH)
    if kernel and chunk < 1:
        raise ValueError(f"decode_megakernel_max_batch must be >= 1, got {chunk}")
    return kernel, chunk


def refuse_for_tacotron2(cfg: Config) -> None:
    """Raises for the decode options Tacotron 2 does not have: speculative
    decode and the windowed cross-attention (both of TransformerTTS's
    decoder)."""
    rt = cfg.runtime
    if int(rt.decode_speculative_k) > 1:
        raise ValueError("model.architecture tacotron2 has no speculative decode "
                         "(runtime.decode_speculative_k must be 0 or 1)")
    if int(rt.decode_attn_window) > 0:
        raise ValueError("model.architecture tacotron2 has no windowed cross-attention "
                         "(runtime.decode_attn_window must be 0)")


def pe_table(model, n: int) -> torch.Tensor:
    """(n, d_model) fp32 ``alpha * PE[:n]`` on the model's device, from the
    model's own fp32 table (the decode-step kernel's PE rows)."""
    return model.pe.alpha.float() * model.pe.pe[:n]


STEPS_MAX = 32  # shapes whose decode-step preparation a DecodeWeights keeps


class DecodeWeights:
    """What every kernel-loop decode of one model reads besides its inputs,
    made again whenever a parameter was written since (``weights_version``):

    - ``packed()``: the decoder weights in the kernel's layout;
      ``packed(verify=True)``: the verify kernel's copy of them
      (``pack_verify_weights``), made at its first use;
    - ``prepared(b, n_pos, tp, device)``: per shape (B, n_pos, max(n_pos,
      Tp)), ``alpha * PE[:n_pos]`` and, on CUDA, the decode step's
      ``StepPrep`` (plan, its tables on the device, the weights' pointers),
      the ``STEPS_MAX`` shapes used last.

    For a Tacotron 2 model the packed weights are ``pack_tacotron2_weights``'
    and the preparation per (B, Tp) is a ``Tacotron2Prep`` (no PE rows).

    So no request's set-up packs, plans or uploads again what an earlier
    request of its shape made.  Thread-safe: one lock guards the cache."""

    def __init__(self, model):
        self.model, self.t2 = model, is_tacotron2(model)
        self._lock = threading.Lock()
        self._cache: dict = {}  # "key": the parameters' versions the entries were made from

    def _current(self) -> dict:
        key = weights_version(self.model)
        if self._cache.get("key") != key:  # the weights changed since the last pack
            pack = pack_tacotron2_weights if self.t2 else pack_decode_weights
            self._cache = {"key": key, "packed": pack(self.model, self.model.dtype),
                           "steps": OrderedDict(), "pe": {}}
        return self._cache

    def __call__(self, verify: bool = False) -> dict:
        with self._lock:
            cache = self._current()
            if verify and "verify" not in cache:
                cache["verify"] = pack_verify_weights(cache["packed"])
            return cache["verify" if verify else "packed"]

    def prepared(self, b: int, n_pos: int, tp: int, device: torch.device) -> tuple:
        """(packed weights, ``alpha * PE[:n_pos]``, ``StepPrep`` or None off
        CUDA, hit) of a chunk of b rows decoding ``n_pos`` positions against
        ``tp`` encoder positions; ``hit``: all of it came from the cache."""
        key = (b, tp, device) if self.t2 else (b, n_pos, max(n_pos, tp), device)
        with self._lock:
            cache = self._current()
            steps = cache["steps"]
            hit = key in steps
            if hit:
                steps.move_to_end(key)
            elif self.t2:  # no PE rows; the step's sizes, pointers and shared memory
                prep = prepare_tacotron2(cache["packed"], b, tp) if device.type == "cuda" else None
                steps[key] = (None, prep)
            else:
                pe = cache["pe"].get(n_pos)
                if pe is None:
                    pe = cache["pe"][n_pos] = pe_table(self.model, n_pos)
                prep = None
                if device.type == "cuda":
                    prep = prepare_step(cache["packed"], b, n_pos, tp,
                                        self.model.cfg.decoder_n_head)
                steps[key] = (pe, prep)
                if len(steps) > STEPS_MAX:
                    steps.popitem(last=False)
            return (cache["packed"], *steps[key], hit)


def prepare_decode(weights: DecodeWeights, cfg: Config, b: int, tp: int, max_len: int,
                   device: torch.device) -> None:
    """Fill ``weights``' cache for a kernel-loop decode of b rows over
    ``tp`` encoder positions to ``max_len`` frames, as the decode would
    (each chunk of rows), without decoding; nothing off the kernel loop."""
    kernel, chunk = decode_options(cfg, device, None)
    if kernel:
        for i in range(0, b, chunk):
            weights.prepared(min(chunk, b - i), max_len // cfg.model.reduction_factor, tp, device)


def make_decode_fn(
    model,
    cfg: Config,
    max_len: Optional[int] = None,
    stop_threshold: Optional[float] = None,
    mask_encoder_source: bool = False,
    use_kernel: Optional[bool] = None,
    device: str | torch.device | None = None,
    weights: Optional[DecodeWeights] = None,
):
    """Returns ``decode(phoneme (B, Tp) int, phoneme_lens (B,) int) -> dict``
    with ``pred_melspec`` / ``post_melspec`` (B, max_len, n_mels),
    ``pred_stop`` (B, max_len), ``n_frames`` (int) and ``n_frames_per_row``
    (B,), as the JAX function, plus ``n_steps``: the decoder steps run,
    summed over the chunks of rows (the kernel's launches on the GPU).
    Frames at positions >= n_frames are zeros before the postnet; so are a
    chunk's frames past its own stop, which lie past its rows' lengths.

    The decode reads the model's weights as they are at each call: the kernel
    loop's packed copy of the decoder weights, and what it prepares per
    shape, are made again whenever a parameter was written since the last
    pack (``weights_version``).  ``weights``: the ``DecodeWeights`` of
    ``model`` that keeps them, shared with the caller's other decode and
    stream functions; None makes one for this function.

    ``use_kernel``: None picks the kernel loop on CUDA — it raises there
    when ``cfg.runtime.use_pallas_decode_step`` is off, and the kernel
    raises for shapes it cannot take — and the plain loop on the CPU.
    True forces the kernel loop (on the CPU the step wrapper then runs its
    plain version); False forces the plain loop.  The kernel loop decodes
    at most ``min(decode_megakernel_max_batch, 8)`` rows per kernel call.

    ``runtime.decode_speculative_k`` K > 1, as the JAX function gates it:
    one utterance (B = 1) decodes speculatively (``SpeculativeDecode``, K
    positions a verify pass) and the result adds ``n_verify_passes``
    (``n_steps`` counts the passes too); a batch falls through to the decode
    above, unchanged.  K > 1 raises with ``infer_prenet_dropout`` > 0 or
    ``decode_attn_window`` > 0, whatever B is, and at B = 1 when max_len / r
    + K - 1 > ``model.max_len``.  One difference from JAX: JAX refuses its
    Pallas step (``use_megakernel=True``) with speculation and runs the XLA
    chunk loop, while here ``use_kernel`` picks the verify kernel (its plain
    version on the CPU) or the plain chunk loop as for the decode above: on
    CUDA the kernel is the path.
    """
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, decode asked for {device}")
    max_len = max_len or cfg.runtime.infer_max_len
    stop_threshold = (
        stop_threshold if stop_threshold is not None else cfg.runtime.stop_threshold
    )
    r = cfg.model.reduction_factor
    if max_len % r:
        raise ValueError(f"max_len ({max_len}) must be a multiple of reduction_factor ({r})")
    t2 = is_tacotron2(model)
    if t2:
        refuse_for_tacotron2(cfg)
    prenet_dropout = float(cfg.runtime.infer_prenet_dropout)
    prenet_drop_args(prenet_dropout)  # raises outside [0, 1)
    spec_k = int(cfg.runtime.decode_speculative_k)
    if spec_k > 1 and (prenet_dropout > 0.0 or int(cfg.runtime.decode_attn_window) > 0):
        raise ValueError("decode_speculative_k is incompatible with "
                         "infer_prenet_dropout / decode_attn_window")
    kernel, chunk = decode_options(cfg, device, use_kernel)
    n_pos = max_len // r
    if weights is None:
        weights = DecodeWeights(model)

    @torch.inference_mode()
    def decode(phoneme, phoneme_lens) -> dict:
        phoneme = torch.as_tensor(phoneme, dtype=torch.long, device=device)
        lens = torch.as_tensor(phoneme_lens, dtype=torch.long, device=device)
        with trace.scope():  # one decode, one trace (the caller's when it has one)
            # one utterance; batches fall through
            if spec_k > 1 and phoneme.shape[0] == 1 and not t2:
                if n_pos + spec_k - 1 > cfg.model.max_len:
                    # the pass reads PE rows [t, t + K): past the table's end they
                    # would shift even position 0's encoding, which is always accepted
                    raise ValueError(f"max_len/r + decode_speculative_k - 1 ({n_pos + spec_k - 1}) "
                                     f"must be <= model.max_len ({cfg.model.max_len})")
                spec = SpeculativeDecode(model, cfg, phoneme, lens, max_len, stop_threshold, kernel,
                                         weights() if kernel else None, mask_encoder_source,
                                         weights(verify=True) if kernel and device.type == "cuda"
                                         else None)
                spec.run()
                return _result(model, spec.frames, spec.stops, spec.t * r, stop_threshold,
                               spec.passes, n_verify_passes=spec.passes)
            state = DecodeState(model, cfg, phoneme, lens, max_len, stop_threshold, kernel,
                                weights, chunk, prenet_dropout, mask_encoder_source)
            state.run_each(n_pos)
            return _result(model, state.frames, state.stops, state.t * r, stop_threshold,
                           state.n_steps)

    return decode


@torch.inference_mode()
def naive_decode(model, phoneme, phoneme_lens, max_len: int, stop_threshold: float = 0.5) -> dict:
    """Cacheless re-compute decode mirroring the reference's inference loop
    (model/model.py:354-374), generalised to reduction_factor, as the JAX
    ``naive_decode``: at every group the whole decoder runs over the emitted
    prefix through ``model.decode`` and ``decode_frame_heads``, and the loop
    ends when every row has voted stop or at ``max_len``.  Plain PyTorch on
    the model's device; slow: the equivalence oracle of the cached loops.
    Returns ``pred_melspec`` / ``post_melspec`` (B, n_frames, n_mels),
    ``pred_stop`` (B, n_frames) and ``n_frames``."""
    cfg, device = model.cfg, model.device
    r = cfg.reduction_factor
    if max_len % r:
        raise ValueError(f"max_len ({max_len}) must be a multiple of reduction_factor ({r})")
    phoneme = torch.as_tensor(phoneme, dtype=torch.long, device=device)
    lens = torch.as_tensor(phoneme_lens, dtype=torch.long, device=device)
    memory = model.encode(phoneme, None)  # unmasked encoder, as the reference
    b = phoneme.shape[0]
    mel = torch.zeros((b, 0, cfg.n_mels), dtype=torch.float32, device=device)
    stops = []
    for g in range(1, max_len // r + 1):
        # the whole decoder over the emitted prefix, grouped as shift_right groups it
        pad = torch.zeros((b, g * r - mel.shape[1], cfg.n_mels), device=device)
        tgt_in = shift_right(torch.cat([mel, pad], dim=1), r)
        tgt_out, _ = model.decode(memory, tgt_in, lens,
                                  torch.full((b,), g * r, dtype=torch.long, device=device),
                                  return_alignments=False)
        mel_g, stop_g = model.decode_frame_heads(tgt_out[:, -1:, :])
        mel = torch.cat([mel, mel_g.float()], dim=1)
        stops.append(stop_g.float())
        if bool((torch.sigmoid(stop_g.float()) >= stop_threshold).any(dim=1).all()):
            break
    return {"pred_melspec": mel, "post_melspec": model.apply_postnet(mel).float(),
            "pred_stop": torch.cat(stops, dim=1), "n_frames": mel.shape[1]}


def _result(model, frames, stops, n_frames: int, stop_threshold: float, n_steps: int,
            **extra) -> dict:
    """``make_decode_fn``'s dict from a decode's buffers."""
    pred = frames[:, 1:, :]
    with trace.span("decode.postnet"):
        post = model.apply_postnet(pred).float()
        per_row = per_row_lengths(stops, n_frames, stop_threshold)
    return {
        "pred_melspec": pred,
        "post_melspec": post,
        "pred_stop": stops,
        "n_frames": n_frames,
        "n_frames_per_row": per_row,
        "n_steps": n_steps,
        **extra,
    }


def weights_version(model) -> tuple:
    """Identity and in-place version of every parameter: it changes when an
    optimizer step, ``load_state_dict`` or any other in-place write touches
    a weight, so a decode closure knows when its packed copy is stale."""
    return tuple((id(p), p._version) for p in model.parameters())
