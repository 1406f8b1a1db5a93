"""Dataset + bucketed-length, host-sharded batch iterator
(``transformertts_tpu/data/dataset.py``).

- validation split = utterances with id prefix LJ001/LJ002/LJ003, train =
  the rest;
- per item: phoneme id sequence + mel transposed to (T, n_mels);
- batches sorted by phoneme length descending and zero-padded.

Every utterance is assigned to a static (phoneme_bucket, mel_bucket)
rectangle and batches are formed within buckets, which bounds the number of
distinct batch shapes to |phoneme_buckets| x |mel_buckets| while keeping
padding waste low.  Batches carry a leading grad-accumulation axis
(K, B, ...) matching the train step.  Multi-host: every process builds the
IDENTICAL global job schedule (same buckets, same RNG), then takes a strided
slice of each job's item chunk — hosts see disjoint data while job count,
order, and bucket shapes stay aligned across processes.  (A per-host bucket
split would let job counts diverge: a 127-item bucket at group 64 yields one
job on host 0 and zero on host 1.)

Batches are read by the threaded C++ npz reader (``native/``) where it can
run, as in the JAX package, else with numpy; both give the same bytes.
Unlike the JAX loader, nothing falls back quietly: ``use_native="auto"``
reads with numpy, with a warning, only when no host C++ compiler exists or
from the first file with a compressed member on; every other failure of
the reader raises.  ``loader.reader`` and ``loader.reads`` say which reader
read the batches.
"""

from __future__ import annotations

import json
import logging
from bisect import bisect_left
from pathlib import Path

import numpy as np

from transformertts_tpu_torch._build import NoHostCompiler
from transformertts_tpu_torch.native import NativeBatchLoader, NativeReadError

log = logging.getLogger("transformertts_tpu_torch.data")

VAL_PREFIXES = ("LJ001", "LJ002", "LJ003")  # ref: dataset.py:50-55


def load_stats(preprocessed_dir: str | Path) -> dict:
    with open(Path(preprocessed_dir) / "stats.json", encoding="utf-8") as f:
        return json.load(f)


def pick_bucket(value: int, buckets: tuple[int, ...]) -> int | None:
    """Smallest bucket >= value, or None if value exceeds the largest."""
    i = bisect_left(buckets, value)
    return buckets[i] if i < len(buckets) else None


class LJSpeechDataset:
    """npz-backed dataset with a cached length index."""

    def __init__(self, preprocessed_dir: str | Path, split: str = "train"):
        base = Path(preprocessed_dir)
        files = sorted(p for p in base.glob("*.npz"))
        if split == "train":
            self.files = [p for p in files if not p.stem.startswith(VAL_PREFIXES)]
        elif split == "val":
            self.files = [p for p in files if p.stem.startswith(VAL_PREFIXES)]
        else:
            raise ValueError(f"bad split {split}")
        self._lengths = self._load_length_index(base, split, files)

    def _load_length_index(self, base: Path, split: str, all_files) -> list[tuple[int, int]]:
        index_path = base / "length_index.json"
        idx = None
        if index_path.exists():
            with open(index_path, encoding="utf-8") as f:
                idx = json.load(f)
            if not all(p.stem in idx for p in all_files):  # stale index
                idx = None
        if idx is None:
            idx = {}
            for p in all_files:
                with np.load(p, allow_pickle=True) as z:
                    idx[p.stem] = [int(z["sequence"].shape[0]), int(z["melspec"].shape[1])]
            try:
                with open(index_path, "w", encoding="utf-8") as f:
                    json.dump(idx, f)
            except OSError:  # read-only data dir: recompute next time
                pass
        return [tuple(idx[p.stem]) for p in self.files]

    def __len__(self) -> int:
        return len(self.files)

    def lengths(self, i: int) -> tuple[int, int]:
        """(phoneme_len, mel_frames) without loading arrays."""
        return self._lengths[i]

    def __getitem__(self, i: int) -> dict:
        with np.load(self.files[i], allow_pickle=True) as z:
            return {
                "sequence": z["sequence"].astype(np.int32),
                "melspec": z["melspec"].T.astype(np.float32),  # (T, n_mels)
                "transcript": str(z["transcript"]),
            }


class BucketedLoader:
    """Yields (K, B, ...) batches from static length buckets."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        phoneme_buckets: tuple[int, ...],
        mel_buckets: tuple[int, ...],
        n_mels: int = 80,
        grad_acc_steps: int = 1,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
        use_native: bool | str = "auto",
        n_threads: int = 4,
    ):
        if use_native not in (True, False, "auto"):
            raise ValueError(f"use_native must be True, False or 'auto', got {use_native!r}")
        self.ds = dataset
        self.batch_size = batch_size
        self.k = grad_acc_steps
        self.pb = tuple(phoneme_buckets)
        self.mb = tuple(mel_buckets)
        self.n_mels = n_mels
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed

        # the C++ reader for datasets of files (native/npz_loader.cpp)
        self.use_native = use_native
        self._native = None
        if use_native and hasattr(dataset, "files"):
            try:
                self._native = NativeBatchLoader(dataset.files, n_threads=n_threads)
            except NoHostCompiler as e:
                if use_native is True:
                    raise
                log.warning("reading with numpy, not the native npz reader: %s", e)
        self.reads = {"native": 0, "numpy": 0}  # micro-batches read by each reader

        # bucket assignment (items too long for the largest bucket are dropped)
        self.buckets: dict[tuple[int, int], list[int]] = {}
        dropped = 0
        for i in range(len(dataset)):
            p_len, m_len = dataset.lengths(i)
            bp, bm = pick_bucket(p_len, self.pb), pick_bucket(m_len, self.mb)
            if bp is None or bm is None:
                dropped += 1
                continue
            self.buckets.setdefault((bp, bm), []).append(i)
        if dropped:
            log.warning(
                "dropped %d/%d items exceeding max bucket (%d, %d)",
                dropped, len(dataset), self.pb[-1], self.mb[-1],
            )
        # host shard: jobs are built over the GLOBAL bucket lists (identical
        # on every process) and each host strides within a job's chunk, so
        # schedules can never misalign across hosts (see module docstring)
        self.process_index = process_index
        self.process_count = process_count

    def batches_per_epoch(self) -> int:
        n, group = 0, self.batch_size * self.k * self.process_count
        for idxs in self.buckets.values():
            n += len(idxs) // group if self.drop_last else -(-len(idxs) // group)
        return n

    @property
    def reader(self) -> str:
        """``"native"`` or ``"numpy"``: the reader of the next micro-batch."""
        return "numpy" if self._native is None else "native"

    def _read(self, idxs: list[int], bp: int, bm: int) -> dict:
        """The zero-padded rows ``idxs`` and their lengths, by the native
        reader where it is on, else by numpy."""
        if self._native is not None:
            try:
                batch = self._native.load_batch(np.asarray(idxs, np.int32), bp, bm, self.n_mels)
            except NativeReadError as e:
                if self.use_native is True or not e.deflated_only:
                    raise
                log.warning("reading with numpy from here on, not the native npz reader: %s", e)
                self._native.close()
                self._native = None
            else:
                self.reads["native"] += 1
                return batch
        self.reads["numpy"] += 1
        return self._read_numpy(idxs, bp, bm)

    def _read_numpy(self, idxs: list[int], bp: int, bm: int) -> dict:
        b = len(idxs)
        items = [self.ds[i] for i in idxs]
        phoneme = np.zeros((b, bp), np.int32)
        melspec = np.zeros((b, bm, self.n_mels), np.float32)
        p_lens = np.zeros((b,), np.int32)
        m_lens = np.zeros((b,), np.int32)
        for j, it in enumerate(items):
            seq, mel = it["sequence"], it["melspec"]
            p_lens[j], m_lens[j] = len(seq), mel.shape[0]
            phoneme[j, : len(seq)] = seq
            melspec[j, : mel.shape[0]] = mel
        return {
            "phoneme": phoneme, "melspec": melspec,
            "phoneme_lens": p_lens, "melspec_lens": m_lens,
        }

    def _pad_batch(self, idxs: list[int], bp: int, bm: int, n_real: int | None = None) -> dict:
        """Load+pad one micro-batch; rows at positions >= n_real are
        repeat-padding for a partial final group — their melspec_lens are
        zeroed so the length-masked loss/metrics exclude them exactly."""
        n_real = len(idxs) if n_real is None else n_real
        batch = self._read(idxs, bp, bm)
        batch["melspec_lens"][n_real:] = 0  # mask repeat-padded rows
        # sort desc by phoneme length (ref: dataset.py:74-77)
        order = np.argsort(-batch["phoneme_lens"], kind="stable")
        return {name: arr[order] for name, arr in batch.items()}

    def epoch(self, epoch_num: int = 0):
        """Iterate (K, B, ...) batches; deterministic per (seed, epoch).

        The schedule (shuffles, grouping, job order) is computed over the
        global index lists with the same seed on every process, so every
        host sees the same job sequence; only the strided slice of each
        chunk differs per host.
        """
        rng = np.random.default_rng(self.seed + epoch_num)
        group = self.batch_size * self.k * self.process_count
        jobs: list[tuple[tuple[int, int], list[int], int]] = []
        for key, idxs in self.buckets.items():
            idxs = list(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            for s in range(0, len(idxs), group):
                chunk = idxs[s : s + group]
                if len(chunk) < group and self.drop_last:
                    continue
                n_real = len(chunk)
                if n_real < group:  # repeat-pad final partial group
                    chunk = (chunk * (group // n_real + 1))[:group]
                jobs.append((key, chunk, n_real))
        if self.shuffle:
            rng.shuffle(jobs)

        pid, pcnt = self.process_index, self.process_count
        for (bp, bm), chunk, n_real in jobs:
            if pcnt > 1:
                # strided slice keeps real items (chunk positions < n_real)
                # ahead of repeat-padding within this host's view
                chunk = chunk[pid::pcnt]
                n_real = len(range(pid, n_real, pcnt))
            micro = [
                self._pad_batch(
                    chunk[m * self.batch_size : (m + 1) * self.batch_size], bp, bm,
                    n_real=max(0, min(self.batch_size, n_real - m * self.batch_size)),
                )
                for m in range(self.k)
            ]
            yield {
                name: np.stack([mb[name] for mb in micro]) for name in micro[0]
            }

    def __iter__(self):
        return self.epoch(0)
