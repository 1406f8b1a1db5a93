"""High-level synthesis API (``transformertts_tpu/infer/api.py``).

``Synthesizer`` packages the serving pipeline — g2p, bucket padding,
KV-cached decode (the CUDA decode-step kernel on the GPU), mel
denormalization, Griffin-Lim waveforms — behind one object, one-shot
(``synthesize``) or streamed chunk by chunk (``stream``).

Spans (``utils/trace.py``): ``synth.g2p`` (text to padded ids) and
``synth.deliver`` (copies to the host, per-row slicing, denormalization)
around the decode's own (``decode.*``), all under one trace id per call: the
caller's (a batch of ``DynamicBatcher``) or a new one.  A stream keeps its
trace id across its chunks.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from transformertts_tpu_torch.config import Config
from transformertts_tpu_torch.convert import torch_state_from_jax
from transformertts_tpu_torch.data.dataset import load_stats, pick_bucket
from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.dsp import denormalize_mel
from transformertts_tpu_torch.dsp.griffin_lim import griffin_lim
from transformertts_tpu_torch.infer.decode import make_decode_fn
from transformertts_tpu_torch.infer.streaming import make_stream_fns, stream_chunks
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.text import G2p, phonemize
from transformertts_tpu_torch.train.checkpoint import load_eval_weights
from transformertts_tpu_torch.utils import trace


class Synthesizer:
    def __init__(
        self,
        cfg: Config,
        variables: Optional[dict] = None,
        state_dict: Optional[dict] = None,
        stats: Optional[dict] = None,
        device: str | torch.device | None = None,
        checkpoint_dir: str | Path | None = None,
    ):
        """Weights from one of: a checkpoint directory of this package's
        trainer (``checkpoint_dir``: its eval params, the EMA copy when the
        checkpoint carries one, and BatchNorm statistics), the JAX package's
        flax ``variables`` (numpy tree, through
        ``convert.torch_state_from_jax``) or this package's ``state_dict``.
        ``device`` None means the GPU."""
        if sum(x is not None for x in (checkpoint_dir, variables, state_dict)) != 1:
            raise ValueError("need exactly one of checkpoint_dir, variables or state_dict")
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if cfg.runtime.compute_dtype == "bfloat16" else torch.float32
        self.model = TransformerTTS(cfg.model, dtype=dtype, device=self.device)
        if checkpoint_dir is not None:
            load_eval_weights(self.model, cfg, checkpoint_dir)
        else:
            if variables is not None:
                state_dict = torch_state_from_jax(variables, cfg.model)
            self.model.load_state_dict(state_dict, strict=True)
        self.g2p = G2p()

        if stats is None and cfg.audio.normalize_mel:
            try:
                stats = load_stats(cfg.path.preprocessed)
            except (FileNotFoundError, OSError):
                stats = None
        self.stats = stats
        self._decoders: dict[tuple, object] = {}
        self._streams: dict[tuple, tuple] = {}
        self.steps_decoded = 0  # decode steps run, summed over batches and row chunks

    def _decode_fn(self, max_len: int, stop_threshold: Optional[float]):
        key = (max_len, stop_threshold)
        if key not in self._decoders:
            self._decoders[key] = make_decode_fn(
                self.model, self.cfg, max_len=max_len, stop_threshold=stop_threshold,
                device=self.device,
            )
        return self._decoders[key]

    def text_to_ids(self, text: str) -> np.ndarray:
        _, seq = phonemize(text, self.g2p)
        return np.asarray(seq, np.int32)

    def warmup(
        self,
        batch_sizes: tuple[int, ...] = (1,),
        buckets: Optional[tuple[int, ...]] = None,
        max_len: Optional[int] = None,
    ) -> int:
        """One dummy decode per (bucket, batch size), so that the kernels
        are built and loaded before the first request.  Returns the count."""
        buckets = tuple(buckets or self.cfg.runtime.phoneme_buckets)
        decode = self._decode_fn(max_len or self.cfg.runtime.infer_max_len, None)
        n = 0
        for bucket in buckets:
            for b in batch_sizes:
                phoneme = np.ones((int(b), bucket), np.int32)
                lens = np.full((int(b),), bucket, np.int32)
                decode(phoneme, lens)
                n += 1
        return n

    def synthesize(
        self,
        texts: str | list[str],
        max_len: Optional[int] = None,
        denormalize: bool = True,
        stop_threshold: Optional[float] = None,
    ) -> list[np.ndarray]:
        """Texts -> list of (n_mels, T) mel spectrograms (variable T).

        ``stop_threshold`` None takes ``cfg.runtime.stop_threshold``."""
        if isinstance(texts, str):
            texts = [texts]
        with trace.scope():
            with trace.span("synth.g2p"):
                seqs = [self.text_to_ids(t) for t in texts]
                bucket = pick_bucket(
                    max(len(s) for s in seqs), self.cfg.runtime.phoneme_buckets
                ) or self.cfg.runtime.phoneme_buckets[-1]
                b = len(seqs)
                phoneme = np.zeros((b, bucket), np.int32)
                lens = np.zeros((b,), np.int32)
                for i, s in enumerate(seqs):
                    s = s[:bucket]
                    phoneme[i, : len(s)] = s
                    lens[i] = len(s)

            decode = self._decode_fn(max_len or self.cfg.runtime.infer_max_len, stop_threshold)
            out = decode(phoneme, lens)
            self.steps_decoded += out["n_steps"]
            with trace.span("synth.deliver"):
                post = out["post_melspec"].cpu().numpy()
                per_row = out["n_frames_per_row"].cpu().numpy()
                mels = []
                for i in range(b):
                    # per-row usable length: frames up to this row's own stop vote,
                    # bounded by the global stop step
                    n = max(int(per_row[i]), 1)
                    mel = post[i, :n].T  # (n_mels, T)
                    if denormalize and self.stats is not None:
                        mel = denormalize_mel(mel, self.stats["mean"], self.stats["std"])
                    mels.append(mel.astype(np.float32))
        return mels

    def stream(
        self,
        text: str,
        chunk: int = 64,
        max_len: Optional[int] = None,
        denormalize: bool = True,
    ):
        """Text -> iterator of (n_mels, <= chunk) fp32 mel chunks as they
        decode.

        Chunks are postnet-final (the one-shot decode's frames, see
        ``infer/streaming.py``) and arrive at most
        ceil(postnet_overlap / chunk) chunks behind the decoder.  The row is
        padded to the smallest bucket that holds it, and ``max_len``
        (default ``runtime.infer_max_len``) is rounded up to whole chunks:
        the decode still ends at the stop vote."""
        with trace.scope() as tid:
            with trace.span("synth.g2p"):
                seq = self.text_to_ids(text)
                buckets = self.cfg.runtime.phoneme_buckets
                bucket = pick_bucket(len(seq), buckets) or buckets[-1]
                n = min(len(seq), bucket)
                phoneme = np.zeros((1, bucket), np.int32)
                phoneme[0, :n] = seq[:n]
                lens = np.array([n], np.int32)
            max_len = max_len or self.cfg.runtime.infer_max_len
            max_len = -(-max_len // chunk) * chunk
            key = (max_len, chunk)
            if key not in self._streams:
                self._streams[key] = make_stream_fns(self.model, self.cfg, max_len=max_len,
                                                     chunk=chunk, device=self.device)
            fns = self._streams[key]
            chunks = stream_chunks(fns, self.cfg, fns[0](phoneme, lens), max_len)
        while True:
            with trace.scope(tid):  # each resumption decodes under the request's trace
                item = next(chunks, None)
                if item is None:
                    return
                _, post, steps = item
                self.steps_decoded += steps
                with trace.span("synth.deliver"):
                    mel = post[0].T  # (n_mels, <= chunk)
                    if denormalize and self.stats is not None:
                        mel = denormalize_mel(mel, self.stats["mean"], self.stats["std"])
                    mel = mel.astype(np.float32)
            yield mel

    def mel_to_wav(self, mel: np.ndarray) -> np.ndarray:
        """(n_mels, T) log-mel (as ``synthesize`` returns it) -> waveform by
        Griffin-Lim on this synthesizer's device."""
        a = self.cfg.audio
        return griffin_lim(torch.from_numpy(np.ascontiguousarray(mel)).to(self.device),
                           a.sample_rate, a.n_fft, a.hop_length, a.win_length, a.fmin, a.fmax)

    def synthesize_wav(self, text: str, **kw) -> np.ndarray:
        """Text -> waveform via Griffin-Lim."""
        return self.mel_to_wav(self.synthesize(text, **kw)[0])
