"""Streaming (chunked) KV-cached decoding (``transformertts_tpu/infer/streaming.py``).

The decode advances in chunks of frames and yields audio-ready mel as it
goes instead of waiting for the whole utterance.  It runs on the one-shot
decode's own state (``infer/decode.py:DecodeState``): the stream's
``init`` builds it, ``chunk_fn`` advances every chunk of rows in lockstep
by ``chunk // r`` positions, so a streamed frame is the frame the one-shot
decode computes.  On the GPU every step is one launch of the decode-step
kernel per chunk of rows, through the ``DecodeStep``(s) and packed weights
that ``init`` prepared; the plain loop runs only for ``use_kernel=False``.
As the JAX stream, the whole batch stops when every row has voted, and the
stream reads neither ``runtime.infer_prenet_dropout`` nor
``runtime.decode_speculative_k``: it decodes without prenet dropout, one
position a step.  A Tacotron 2 stream does drop (its prenet's dropout is
part of the model at inference), with the one-shot decode's masks.

Postnet exactness: the postnet is NON-causal — n_layers convs of kernel k
give a receptive field of ``overlap = n_layers*(k-1)//2`` frames on EACH
side.  ``stream_decode`` emits a chunk's postnet frames once the decode has
advanced ``overlap`` frames past the chunk's end (or the utterance ended),
computed over a window extended ``overlap`` frames into past and future and
CLAMPED into ``[0, max_len]``, then trimmed: a clamped edge coincides with
the one-shot buffer's edge (where each conv layer pads alike), an unclamped
one has ``overlap`` frames of real context, so the trimmed interior equals
the postnet over the whole buffer.

Spans (``utils/trace.py``): ``init`` is ``DecodeState``'s ``decode.init``,
each ``chunk_fn`` one ``decode.loop``, each ``post_fn`` one
``decode.postnet``, and each chunk's copies to the host ``synth.deliver``.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from transformertts_tpu_torch.config import Config
from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.infer.decode import (
    DecodeState,
    DecodeWeights,
    decode_options,
    refuse_for_tacotron2,
)
from transformertts_tpu_torch.models.factory import is_tacotron2
from transformertts_tpu_torch.utils import trace


def postnet_overlap(cfg: Config) -> int:
    """One-sided receptive field of the postnet in frames."""
    return cfg.model.postnet_n_layers * ((cfg.model.postnet_kernel_size - 1) // 2)


def make_stream_fns(
    model,
    cfg: Config,
    max_len: Optional[int] = None,
    chunk: int = 64,
    stop_threshold: Optional[float] = None,
    use_kernel: Optional[bool] = None,
    device: str | torch.device | None = None,
    weights: Optional[DecodeWeights] = None,
):
    """Returns (init, chunk_fn, post_fn).

    init(phoneme (B, Tp) int, phoneme_lens (B,) int) -> state
        Encodes (unmasked, as the one-shot decode) and prepares the decode:
        a ``DecodeState`` whose ``frames`` hold the go frame at 0.
    chunk_fn(state) -> (state, pred (B, chunk, n_mels), n_new)
        Decodes up to ``chunk`` new pre-postnet frames; frames beyond the
        stop step are zeros and ``n_new`` counts the real ones.
    post_fn(frames, start) -> (B, chunk, n_mels) fp32
        The exact postnet output for positions [start, start + chunk),
        valid once the decode has advanced to ``start + chunk + overlap``
        (or ended).  ``frames`` is ``state.frames``.

    ``use_kernel``, ``device`` and ``weights`` as ``make_decode_fn``: on
    CUDA the chunks run on the decode-step kernel, batches above
    ``min(decode_megakernel_max_batch, 8)`` rows as row chunks in lockstep.
    """
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, stream asked for {device}")
    max_len = max_len or cfg.runtime.infer_max_len
    if max_len % chunk:
        raise ValueError(f"max_len ({max_len}) must be a multiple of chunk ({chunk})")
    stop_threshold = (
        stop_threshold if stop_threshold is not None else cfg.runtime.stop_threshold
    )
    r = cfg.model.reduction_factor
    if chunk % r:
        raise ValueError(f"chunk ({chunk}) must be a multiple of reduction_factor ({r})")
    kernel, rows = decode_options(cfg, device, use_kernel)
    prenet_dropout = 0.0
    if is_tacotron2(model):  # its prenet drops at inference: the one-shot decode's frames
        refuse_for_tacotron2(cfg)
        prenet_dropout = float(cfg.runtime.infer_prenet_dropout)
    n_pos, chunk_pos = max_len // r, chunk // r
    overlap = postnet_overlap(cfg)
    if weights is None:
        weights = DecodeWeights(model)

    @torch.inference_mode()
    def init(phoneme, phoneme_lens) -> DecodeState:
        phoneme = torch.as_tensor(phoneme, dtype=torch.long, device=device)
        lens = torch.as_tensor(phoneme_lens, dtype=torch.long, device=device)
        return DecodeState(model, cfg, phoneme, lens, max_len, stop_threshold, kernel, weights,
                           rows, prenet_dropout=prenet_dropout)

    @torch.inference_mode()
    def chunk_fn(state: DecodeState):
        start = state.t
        state.run_lockstep(min(start + chunk_pos, n_pos))
        pred = state.frames[:, start * r + 1: start * r + 1 + chunk]
        return state, pred, (state.t - start) * r

    # the window's length; clamped so that the window never leaves [0, max_len]
    win_len = min(chunk + 2 * overlap, max_len)

    @torch.inference_mode()
    def post_fn(frames: torch.Tensor, start: int) -> torch.Tensor:
        lo = min(max(start - overlap, 0), max_len - win_len)
        window = frames[:, lo + 1: lo + 1 + win_len]
        with trace.span("decode.postnet"):
            post = model.apply_postnet(window).float()
        return post[:, start - lo: start - lo + chunk]

    return init, chunk_fn, post_fn


def stream_chunks(fns, cfg: Config, state: DecodeState, max_len: int,
                  ) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """``stream_decode``'s chunks of the decode ``state`` (from ``fns``'
    ``init``; ``fns`` from ``make_stream_fns``), each with the decode steps
    run since the previous one (summed over the chunks of rows: the
    kernel's launches on the GPU)."""
    _, chunk_fn, post_fn = fns
    overlap = postnet_overlap(cfg)
    pending: list[tuple[int, np.ndarray, int]] = []  # (start, pred, n)
    t, steps = 0, 0
    while True:
        before = state.n_steps
        state, pred, n = chunk_fn(state)
        steps += state.n_steps - before
        if n:
            with trace.span("synth.deliver"):
                pending.append((t, pred[:, :n].cpu().numpy(), n))
        t += n
        done = n < pred.shape[1] or t >= max_len
        while pending and (done or pending[0][0] + pending[0][2] + overlap <= t):
            s, p, n_p = pending.pop(0)
            post = post_fn(state.frames, s)[:, :n_p]
            with trace.span("synth.deliver"):
                post = post.cpu().numpy()
            yield p, post, steps
            steps = 0
        if done:
            break


def stream_decode(
    model,
    cfg: Config,
    phoneme,
    phoneme_lens,
    max_len: Optional[int] = None,
    chunk: int = 64,
    stop_threshold: Optional[float] = None,
    use_kernel: Optional[bool] = None,
    device: str | torch.device | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yields aligned (pre_postnet, postnet) numpy chunks of shape
    (B, <= chunk, n_mels).

    Pre-postnet frames are decoded eagerly; their postnet counterparts are
    finalized (and the pair yielded) once ``overlap`` frames of right context
    exist, so emission lags the decode by at most ceil(overlap / chunk)
    chunks.
    """
    max_len = max_len or cfg.runtime.infer_max_len
    fns = make_stream_fns(model, cfg, max_len, chunk, stop_threshold, use_kernel, device)
    for pre, post, _ in stream_chunks(fns, cfg, fns[0](phoneme, phoneme_lens), max_len):
        yield pre, post
