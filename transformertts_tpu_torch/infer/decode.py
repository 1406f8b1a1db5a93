"""KV-cached autoregressive greedy mel decoding (``transformertts_tpu/infer/decode.py``).

Two loops with one result:

- the plain loop mirrors the JAX XLA loop (``decode.py:191-302``): the
  encoder runs unmasked (the reference's quirk, model/model.py:345-348),
  cross-attention K/V are built once, the self-attention caches grow by one
  row per step, a row stops voting when ``sigmoid(stop) >= threshold`` and
  the loop ends when every row has voted or at ``max_len``;
- the kernel loop mirrors ``_megakernel_decode(_batched)``
  (``decode.py:522-685``): each step is ONE launch of the decode-step
  kernel on the GPU, through an ``ops.decode_step.DecodeStep`` prepared
  once per chunk of rows (checks, plan, buffers), so a step costs the host
  one C call.  A batch larger than the kernel takes is decoded as
  consecutive chunks of rows.

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

The loop runs in Python and reads the stop votes back once per step.

Spans (``utils/trace.py``): ``decode.init`` (``DecodeState`` and
``SpeculativeDecode`` set-up) holds ``decode.encode``, ``decode.cross_kv``
and one ``decode.plan`` per chunk of rows (``KernelRows`` or ``PlainRows``:
the PE table, the permuted cross K/V, the caches and the ``DecodeStep``);
``decode.loop`` is one call of ``run_each``, ``run_lockstep`` or
``SpeculativeDecode.run`` with ``steps`` (the steps run, as ``n_steps``
counts them) and ``readback_ns`` (the host's time in the stop readbacks,
two clock reads a step: the rest of the loop is host work); under a running
profiler each step is a ``decode.step`` range as well.  ``decode.postnet``
is the postnet and the rows' lengths of the result.

Speculative decode (``runtime.decode_speculative_k`` K > 1, one utterance:
JAX ``_speculative_decode``) is ``SpeculativeDecode``: each pass drafts K -
1 inputs, verifies the K positions at once and advances by the accepted
groups, reading back one integer a pass; on the GPU a pass is one launch of
the verify kernel (``ops.decode_step.DecodeVerify``), which also drafts,
accepts and writes the frames.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from transformertts_tpu_torch.config import Config
from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.models.masks import NEG_INF, padding_bias
from transformertts_tpu_torch.models.modules import sinusoid_table
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


def _steps(stopped: torch.Tensor, more, step) -> int:
    """Calls ``step()`` while ``more()`` and some row of ``stopped`` has not
    voted, reading the votes back before each step; returns the nanoseconds
    those readbacks took (the host waiting for the device).  Under a running
    profiler each step is a ``decode.step`` range."""
    waited, ranged = 0, trace.profiling()
    while more():
        t0 = time.perf_counter_ns()
        done = bool(stopped.all())
        waited += time.perf_counter_ns() - t0
        if done:
            break
        if ranged:
            with trace.step_range("decode.step"):
                step()
        else:
            step()
    return waited


class DecodeRows:
    """One chunk of rows of a ``DecodeState``: the step body and what only
    this chunk's steps read (caches, window center).  ``frames``, ``stops``
    and ``stopped`` are views of the whole state's buffers; ``row0`` is the
    chunk's first row in the batch."""

    def __init__(self, model, cfg, frames, stops, stopped, cross_kv, cross_bias, n_pos,
                 stop_threshold, row0, prenet_dropout):
        m = cfg.model
        self.model, self.r, self.n_mels = model, m.reduction_factor, m.n_mels
        self.frames, self.stops, self.stopped = frames, stops, stopped
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
        self.stopped |= (torch.sigmoid(stop_t) >= self.stop_threshold).any(dim=1)
        if exp_pos is not None:
            self.center = torch.maximum(self.center, exp_pos)
        self.t += 1

    def run(self, until: int) -> int:
        """Steps until position ``until`` or until every row has voted;
        returns the nanoseconds spent reading the votes back."""
        return _steps(self.stopped, lambda: self.t < until, self.step)


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
    the step is a ``DecodeStep`` prepared here; on the CPU
    ``decode_step``'s plain version."""

    def __init__(self, *args, packed):
        super().__init__(*args)
        model, m = self.model, self.model.cfg
        dev = self.cross_bias.device
        alpha = model.pe.alpha.float()
        self.pe_table = (alpha * torch.from_numpy(
            sinusoid_table(m.max_len, m.d_model)).to(dev)).float()
        # L x (B, Tp, H, dh) -> (L, H, B, Tp, dh)
        ck = torch.stack([kv[0] for kv in self.cross_kv]).permute(0, 3, 1, 2, 4).contiguous()
        cv = torch.stack([kv[1] for kv in self.cross_kv]).permute(0, 3, 1, 2, 4).contiguous()
        self.cbias = self.cross_bias[:, 0, 0, :].float().contiguous()  # (B, Tp)
        shape = (m.decoder_n_layers, m.decoder_n_head, self.b, self.n_pos,
                 m.d_model // m.decoder_n_head)
        self_k = torch.zeros(shape, dtype=model.dtype, device=dev)
        self_v = torch.zeros(shape, dtype=model.dtype, device=dev)
        with_pos = self.attn_win > 0
        if dev.type == "cuda":
            self.decode_step = DecodeStep(self_k, self_v, ck, cv, packed, with_attn_pos=with_pos)
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


class DecodeState:
    """The state of one decode of a batch: the buffers every chunk of rows
    writes (``frames`` (B, max_len + 1, n_mels) fp32 with the go frame at
    0, ``stops`` (B, max_len), ``stopped`` (B,)) and the chunks
    (``rows``): one ``PlainRows`` for the plain loop, ``KernelRows`` of at
    most ``chunk`` rows each for the kernel loop."""

    def __init__(self, model, cfg, phoneme, lens, max_len, stop_threshold, kernel, packed,
                 chunk, prenet_dropout, mask_encoder_source=False):
        b, tp = phoneme.shape
        dev, n_mels = phoneme.device, cfg.model.n_mels
        self.n_pos = max_len // cfg.model.reduction_factor
        with trace.span("decode.init"):
            with trace.span("decode.encode"):
                memory = model.encode(phoneme, lens if mask_encoder_source else None)
            with trace.span("decode.cross_kv"):
                cross_kv = model.build_cross_cache(memory)  # L x ((B, Tp, H, dh) x 2)
                cross_bias = padding_bias(lens, tp)  # (B, 1, 1, Tp)
            self.frames = torch.zeros((b, max_len + 1, n_mels), dtype=torch.float32, device=dev)
            self.stops = torch.full((b, max_len), NEG_INF, dtype=torch.float32, device=dev)
            self.stopped = torch.zeros((b,), dtype=torch.bool, device=dev)
            step = chunk if kernel else b
            self.rows = []
            for i in range(0, b, step):
                part = slice(i, i + step)
                args = (model, cfg, self.frames[part], self.stops[part], self.stopped[part],
                        [(k[part], v[part]) for k, v in cross_kv], cross_bias[part],
                        self.n_pos, stop_threshold, i, prenet_dropout)
                with trace.span("decode.plan", rows=min(step, b - i)):
                    self.rows.append(KernelRows(*args, packed=packed) if kernel
                                     else PlainRows(*args))

    @property
    def t(self) -> int:
        """Positions decoded: the furthest chunk's."""
        return max(rows.t for rows in self.rows)

    @property
    def n_steps(self) -> int:
        """Steps run, summed over the chunks (kernel launches on the GPU)."""
        return sum(rows.t for rows in self.rows)

    def run_each(self, until: int) -> None:
        """Each chunk to position ``until`` or its own rows' votes, in turn."""
        with trace.span("decode.loop") as s:
            before = self.n_steps
            s.attrs["readback_ns"] = sum([rows.run(until) for rows in self.rows])
            s.attrs["steps"] = self.n_steps - before

    def run_lockstep(self, until: int) -> None:
        """Every chunk takes each step, until position ``until`` or until
        every row of the batch has voted (the JAX stream's global stop)."""
        def step() -> None:
            for rows in self.rows:
                rows.step()

        with trace.span("decode.loop") as s:
            before = self.n_steps
            s.attrs["readback_ns"] = _steps(self.stopped, lambda: self.t < until, step)
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
            ck = torch.stack([kv[0] for kv in self.cross_kv]).permute(0, 3, 1, 2, 4).contiguous()
            cv = torch.stack([kv[1] for kv in self.cross_kv]).permute(0, 3, 1, 2, 4).contiguous()
            self_k = torch.zeros((L, H, 1, cap, dh), dtype=model.dtype, device=dev)
            pe_table = (model.pe.alpha.float() * torch.from_numpy(
                sinusoid_table(m.max_len, m.d_model)).to(dev)).float()
            self.verify = DecodeVerify(
                self_k, torch.zeros_like(self_k), ck, cv, packed,
                self.cross_bias[:, 0, 0, :].float().contiguous(), pe_table, self.frames[0],
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
            s.attrs["steps"] = self.passes - before


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


def weights_packer(model):
    """``packed()`` -> the decoder weights in the kernel's layout, packed
    again whenever a parameter was written since the last pack
    (``weights_version``); ``packed(verify=True)`` -> the verify kernel's
    copy of them (``pack_verify_weights``), made once per pack at its first
    use, so that no request's set-up makes it again."""
    cache: dict = {}  # "key": the parameters' versions the packed copy was made from

    def packed(verify: bool = False) -> dict:
        key = weights_version(model)
        if cache.get("key") != key:  # the weights changed since the last pack
            cache.clear()
            cache["packed"] = pack_decode_weights(model, model.dtype)
            cache["key"] = key
        if verify and "verify" not in cache:
            cache["verify"] = pack_verify_weights(cache["packed"])
        return cache["verify" if verify else "packed"]

    return packed


def make_decode_fn(
    model,
    cfg: Config,
    max_len: Optional[int] = None,
    stop_threshold: Optional[float] = None,
    mask_encoder_source: bool = False,
    use_kernel: Optional[bool] = None,
    device: str | torch.device | None = None,
):
    """Returns ``decode(phoneme (B, Tp) int, phoneme_lens (B,) int) -> dict``
    with ``pred_melspec`` / ``post_melspec`` (B, max_len, n_mels),
    ``pred_stop`` (B, max_len), ``n_frames`` (int) and ``n_frames_per_row``
    (B,), as the JAX function, plus ``n_steps``: the decoder steps run,
    summed over the chunks of rows (the kernel's launches on the GPU).
    Frames at positions >= n_frames are zeros before the postnet; so are a
    chunk's frames past its own stop, which lie past its rows' lengths.

    The decode reads the model's weights as they are at each call: the kernel
    loop's packed copy of the decoder weights is made again whenever a
    parameter was written since the last pack (``weights_version``).

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
    prenet_dropout = float(cfg.runtime.infer_prenet_dropout)
    prenet_drop_args(prenet_dropout)  # raises outside [0, 1)
    spec_k = int(cfg.runtime.decode_speculative_k)
    if spec_k > 1 and (prenet_dropout > 0.0 or int(cfg.runtime.decode_attn_window) > 0):
        raise ValueError("decode_speculative_k is incompatible with "
                         "infer_prenet_dropout / decode_attn_window")
    kernel, chunk = decode_options(cfg, device, use_kernel)
    n_pos = max_len // r
    packed = weights_packer(model)

    @torch.inference_mode()
    def decode(phoneme, phoneme_lens) -> dict:
        phoneme = torch.as_tensor(phoneme, dtype=torch.long, device=device)
        lens = torch.as_tensor(phoneme_lens, dtype=torch.long, device=device)
        with trace.scope():  # one decode, one trace (the caller's when it has one)
            if spec_k > 1 and phoneme.shape[0] == 1:  # one utterance; batches fall through
                if n_pos + spec_k - 1 > cfg.model.max_len:
                    # the pass reads PE rows [t, t + K): past the table's end they
                    # would shift even position 0's encoding, which is always accepted
                    raise ValueError(f"max_len/r + decode_speculative_k - 1 ({n_pos + spec_k - 1}) "
                                     f"must be <= model.max_len ({cfg.model.max_len})")
                spec = SpeculativeDecode(model, cfg, phoneme, lens, max_len, stop_threshold, kernel,
                                         packed() if kernel else None, mask_encoder_source,
                                         packed(verify=True) if kernel and device.type == "cuda"
                                         else None)
                spec.run()
                return _result(model, spec.frames, spec.stops, spec.t * r, stop_threshold,
                               spec.passes, n_verify_passes=spec.passes)
            state = DecodeState(model, cfg, phoneme, lens, max_len, stop_threshold, kernel,
                                packed() if kernel else None, chunk, prenet_dropout,
                                mask_encoder_source)
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
