"""Offline preprocessing CLI (``transformertts_tpu/data/preprocess.py``).

``python -m transformertts_tpu_torch.data.preprocess --config config.yaml``

Pipeline per utterance:
  metadata.csv (``id|raw|normalized``) -> g2p phonemes + id sequence,
  wav -> log-mel ``(n_mels, T)`` -> global mean/std normalize -> ``<id>.npz``
  with keys melspec / transcript / phoneme / sequence.

Global scalar mel stats are streamed over the corpus first and written to
``stats.json`` in the preprocessed dir.  Skips entirely if the output dir is
non-empty; a wav that cannot be read, or an utterance that cannot be saved,
warns and the run goes on.

With ``runtime.use_pallas_mel`` (the port's default) the log-mels come in
batches from the fused kernel (``ops/stft.py``) on ``device`` (default: the
GPU; it raises without one); with the flag set to false, from
``mel_spectrogram_np`` on the host, as the JAX package does by default.  An
error of the kernel or of its build is raised, never skipped: the JAX
package's per-chunk tolerance is not carried over.
"""

from __future__ import annotations

import argparse
import json
import logging
import wave
from pathlib import Path

import numpy as np

from transformertts_tpu_torch.config import Config, load_config
from transformertts_tpu_torch.data.audio_io import load_wav
from transformertts_tpu_torch.dsp import mel_spectrogram_np, normalize_mel
from transformertts_tpu_torch.text import G2p, phonemize

log = logging.getLogger("transformertts_tpu_torch.preprocess")


def load_transcripts(metadata_path: Path) -> dict[str, str]:
    """``id|raw|normalized`` -> {id: normalized} (ref: preprocess.py:11-18)."""
    transcripts: dict[str, str] = {}
    with open(metadata_path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 3:
                continue
            transcripts[parts[0]] = parts[2].strip()
    log.info("Loaded %d transcripts", len(transcripts))
    return transcripts


def _mel_for(audio_id: str, cfg: Config) -> np.ndarray:
    wav_path = Path(cfg.path.data) / "wavs" / f"{audio_id}.wav"
    y, _ = load_wav(wav_path, cfg.audio.sample_rate)
    a = cfg.audio
    return mel_spectrogram_np(
        y, a.sample_rate, a.n_fft, a.hop_length, a.win_length, a.fmin, a.fmax, a.n_mels
    )


# granularity of the batched device path: wavs are zero-extended to the next
# multiple of the quantum, so a batch's shape is one of a few
_DEVICE_MEL_BATCH = 32
_DEVICE_LEN_QUANTUM = 32768  # ~1.5 s of 22.05 kHz audio


def _device_mels(ids: list[str], cfg: Config, device=None):
    """Yield (audio_id, log-mel) via BATCHED on-device extraction.

    Clips are sorted by length, reflect-padded individually on the host (so
    the final frames see the true signal, not a batch zero-extension),
    zero-extended to a quantized bucket length, and processed
    _DEVICE_MEL_BATCH at a time by ``ops.stft.log_mel`` (the CUDA kernel on a
    GPU, its plain version when ``device`` is the CPU).  Frame counts are
    exact: each result is sliced to the clip's true 1 + n // hop frames.
    """
    import torch

    from transformertts_tpu_torch.device import resolve_device
    from transformertts_tpu_torch.ops.stft import log_mel

    a = cfg.audio
    pad = a.n_fft // 2
    device = resolve_device(device)

    # sort by length WITHOUT loading audio (wav header only), then stream
    # one batch of wavs at a time — full-corpus residency would be ~8 GB
    # on LJSpeech
    def _header_len(audio_id: str) -> int | None:
        try:
            with wave.open(str(Path(cfg.path.data) / "wavs" / f"{audio_id}.wav"), "rb") as f:
                return int(f.getnframes() * a.sample_rate / f.getframerate())
        except Exception as e:  # noqa: BLE001
            log.warning("mel: skipping %s (header): %s", audio_id, e)
            return None

    with_len = [(i, n) for i in ids if (n := _header_len(i)) is not None]
    with_len.sort(key=lambda t: t[1])
    order = [i for i, _ in with_len]

    def _load_chunk(chunk_ids: list[str]) -> list[tuple[str, np.ndarray]]:
        out = []
        for audio_id in chunk_ids:
            try:
                y, _ = load_wav(Path(cfg.path.data) / "wavs" / f"{audio_id}.wav", a.sample_rate)
                if len(y) == 0:
                    raise ValueError("empty audio")
                out.append((audio_id, y))
            except Exception as e:  # noqa: BLE001
                log.warning("mel: skipping %s: %s", audio_id, e)
        return out

    for i in range(0, len(order), _DEVICE_MEL_BATCH):
        chunk = _load_chunk(order[i:i + _DEVICE_MEL_BATCH])
        if not chunk:
            continue
        max_len = max(len(y) for _, y in chunk) + 2 * pad
        bucket = -(-max_len // _DEVICE_LEN_QUANTUM) * _DEVICE_LEN_QUANTUM
        batch = np.zeros((len(chunk), bucket), np.float32)
        for j, (_, y) in enumerate(chunk):
            batch[j, : len(y) + 2 * pad] = np.pad(y, pad, mode="reflect")
        mels = log_mel(
            torch.from_numpy(batch).to(device), a.sample_rate, a.n_fft, a.hop_length,
            a.win_length, a.fmin, a.fmax, a.n_mels, center=False,
        ).cpu().numpy()
        for j, (audio_id, y) in enumerate(chunk):
            n_frames = 1 + len(y) // a.hop_length
            yield audio_id, mels[j, :, :n_frames]


def _mels_iter(ids: list[str], cfg: Config, device=None):
    """(audio_id, mel) pairs via the configured extraction path, with the
    reference's per-utterance tolerance for wavs that cannot be read."""
    if cfg.runtime.use_pallas_mel:
        yield from _device_mels(ids, cfg, device)
        return
    for audio_id in ids:
        try:
            yield audio_id, _mel_for(audio_id, cfg)
        except Exception as e:  # noqa: BLE001
            log.warning("mel: skipping %s: %s", audio_id, e)


def compute_global_stats(transcripts: dict[str, str], cfg: Config, out_dir: Path, device=None):
    """Streamed corpus mean/std (ref: preprocess.py:45-72)."""
    total, sq_total, count = 0.0, 0.0, 0
    for _audio_id, mel in _mels_iter(list(transcripts), cfg, device):
        count += mel.size
        total += float(mel.sum())
        sq_total += float((mel.astype(np.float64) ** 2).sum())
    mean = total / count
    std = float(np.sqrt(sq_total / count - mean**2 + 1e-8))
    stats = {"mean": mean, "std": std}
    with open(out_dir / "stats.json", "w", encoding="utf-8") as f:
        json.dump(stats, f, indent=2)
    log.info("Global mel stats: mean=%.4f std=%.4f", mean, std)
    return mean, std


def process_and_save(audio_id, transcript, g2p, cfg, out_dir: Path, mean, std,
                     mel: np.ndarray | None = None):
    phoneme, sequence = phonemize(transcript, g2p)
    if mel is None:
        mel = _mel_for(audio_id, cfg)
    if mean is not None and std is not None:
        mel = normalize_mel(mel, mean, std)
    np.savez(
        out_dir / f"{audio_id}.npz",
        melspec=mel.astype(np.float32),
        transcript=transcript,
        phoneme=np.array(phoneme),
        sequence=np.array(sequence, dtype=np.int32),
    )


def preprocess(cfg: Config, device=None) -> None:
    """``device`` is where the batched extraction runs (``runtime.use_pallas_mel``,
    on by default): None means the GPU."""
    out_dir = Path(cfg.path.preprocessed)
    out_dir.mkdir(parents=True, exist_ok=True)
    if any(out_dir.iterdir()):
        log.info("Preprocessed data already exists. Skipping.")
        return

    metadata = Path(cfg.path.data) / "metadata.csv"
    if not metadata.is_file():
        log.error("Metadata file not found at %s", metadata)
        return

    transcripts = load_transcripts(metadata)
    g2p = G2p()
    log.info("g2p backend: %s", g2p.backend)

    mean = std = None
    if cfg.audio.normalize_mel:
        mean, std = compute_global_stats(transcripts, cfg, out_dir, device)

    n_done = 0
    for audio_id, mel in _mels_iter(list(transcripts), cfg, device):
        try:
            process_and_save(
                audio_id, transcripts[audio_id], g2p, cfg, out_dir, mean, std,
                mel=mel,
            )
            n_done += 1
        except Exception as e:  # noqa: BLE001
            log.warning("Error processing %s: %s", audio_id, e)
    log.info("Preprocessing done (%d errors)", len(transcripts) - n_done)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="Offline LJSpeech preprocessing")
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="dotted config override, e.g. path.data=/data/LJSpeech-1.1")
    ap.add_argument("--device", default=None,
                    help="device of the batched extraction (default: the GPU; "
                         "runtime.use_pallas_mel=false extracts with numpy on the host)")
    args = ap.parse_args(argv)
    preprocess(load_config(args.config, args.overrides), device=args.device)


if __name__ == "__main__":
    main()
