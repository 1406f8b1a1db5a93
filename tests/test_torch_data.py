"""PyTorch port vs JAX package: preprocessing, dataset and loader.

One generated corpus (seeded noise plus a tone, 16-bit wavs, ids in both
splits) goes through both packages' ``preprocess`` with
``runtime.use_pallas_mel`` off (numpy FFT on the host in both) and on (the
JAX package's rFFT path off-TPU; the port's ``ops.stft.log_mel`` on the CPU:
the kernel's plain version), and the loaders read what was written.

Tolerances: flag off, the npz arrays and ``stats.json`` are equal (the same
numpy code).  Flag on, the normalized log-mels agree to 2e-2 at most and 2e-3
in the mean (fp32 matrix-product DFT against an fp32 rFFT, the bound the
JAX package's own kernel test uses, divided by a std near 1), the statistics
to 1e-4.  Batches of the two loaders over the same directory are equal.
"""

import json
import logging
import wave

import numpy as np
import pytest
import torch

from transformertts_tpu.config import load_config as jax_load_config
from transformertts_tpu.data import BucketedLoader as JaxLoader
from transformertts_tpu.data import LJSpeechDataset as JaxDataset
from transformertts_tpu.data.preprocess import preprocess as jax_preprocess
from transformertts_tpu_torch.config import load_config
from transformertts_tpu_torch.data import (
    BucketedLoader,
    LJSpeechDataset,
    load_stats,
    pick_bucket,
)
from transformertts_tpu_torch.data import preprocess as pp
from transformertts_tpu_torch.data.audio_io import load_wav
from transformertts_tpu_torch.data.dataset import VAL_PREFIXES
from transformertts_tpu_torch.data.prefetch import batch_to_device, prefetch
from transformertts_tpu_torch.ops.stft import log_mel

N_CLIPS = 14


def write_wav(path, y, sr=22050):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(root, {(package, flag): preprocessed dir}): both packages' outputs
    with the flag off and on."""
    root = tmp_path_factory.mktemp("lj")
    (root / "wavs").mkdir()
    rng = np.random.default_rng(0)
    ids = [f"LJ002-{i:04d}" for i in range(4)] + [f"LJ050-{i:04d}" for i in range(N_CLIPS - 4)]
    lines = []
    for i, audio_id in enumerate(ids):
        n = 4000 + 2100 * (i % 5) + 37 * i
        tone = 0.3 * np.sin(2 * np.pi * (200 + 90 * i) * np.arange(n) / 22050)
        write_wav(root / "wavs" / f"{audio_id}.wav", tone + rng.standard_normal(n) * 0.1)
        text = "Some text " + "and more " * (i % 4) + f"number {i}."
        lines.append(f"{audio_id}|{text}|{text}")
    (root / "metadata.csv").write_text("\n".join(lines))
    out = {}
    for flag in (False, True):
        for name, load, run in (("jax", jax_load_config, jax_preprocess),
                                ("port", load_config, lambda c: pp.preprocess(c, device="cpu"))):
            d = root / f"prep_{name}_{int(flag)}"
            run(load(None, [f"path.data={root}", f"path.preprocessed={d}",
                            f"runtime.use_pallas_mel={str(flag).lower()}"]))
            out[(name, flag)] = d
    return root, out


def _npz(d):
    return {p.stem: dict(np.load(p, allow_pickle=True)) for p in sorted(d.glob("*.npz"))}


def test_preprocess_flag_off_writes_what_jax_writes(corpus):
    _, out = corpus
    ours, theirs = _npz(out[("port", False)]), _npz(out[("jax", False)])
    assert set(ours) == set(theirs) and len(ours) == N_CLIPS
    assert load_stats(out[("port", False)]) == json.loads(
        (out[("jax", False)] / "stats.json").read_text())
    for audio_id, z in ours.items():
        assert set(z) == {"melspec", "transcript", "phoneme", "sequence"}
        for key in z:
            np.testing.assert_array_equal(z[key], theirs[audio_id][key], err_msg=f"{audio_id} {key}")


def test_preprocess_flag_on_matches_jax_and_the_host_path(corpus):
    root, out = corpus
    ours, theirs = _npz(out[("port", True)]), _npz(out[("jax", True)])
    host = _npz(out[("port", False)])
    assert set(ours) == set(theirs) == set(host)
    s_ours, s_theirs = load_stats(out[("port", True)]), load_stats(out[("jax", True)])
    s_host = load_stats(out[("port", False)])
    for key in ("mean", "std"):
        assert abs(s_ours[key] - s_theirs[key]) < 1e-4 and abs(s_ours[key] - s_host[key]) < 1e-4
    for audio_id, z in ours.items():
        y, _ = load_wav(root / "wavs" / f"{audio_id}.wav", 22050)
        assert z["melspec"].shape == (80, 1 + len(y) // 256) and z["melspec"].dtype == np.float32
        for other in (theirs[audio_id], host[audio_id]):
            diff = np.abs(z["melspec"] - other["melspec"])
            assert diff.max() < 2e-2 and diff.mean() < 2e-3, audio_id
            for key in ("transcript", "phoneme", "sequence"):
                np.testing.assert_array_equal(z[key], other[key])


def test_preprocess_skips_when_nonempty_and_without_metadata(corpus, tmp_path, caplog):
    root, out = corpus
    d = out[("port", False)]
    before = sorted(p.name for p in d.iterdir())
    with caplog.at_level(logging.INFO, logger="transformertts_tpu_torch.preprocess"):
        pp.preprocess(load_config(None, [f"path.data={root}", f"path.preprocessed={d}"]))
        pp.preprocess(load_config(None, [f"path.data={tmp_path}",
                                         f"path.preprocessed={tmp_path / 'o'}"]))
    assert sorted(p.name for p in d.iterdir()) == before
    assert "already exists" in caplog.text and "Metadata file not found" in caplog.text


def test_device_path_skips_unreadable_wavs_but_raises_kernel_errors(corpus, tmp_path, monkeypatch):
    root, _ = corpus
    data = tmp_path / "lj"
    (data / "wavs").mkdir(parents=True)
    for name in ("LJ050-0000", "LJ050-0001"):
        (data / "wavs" / f"{name}.wav").write_bytes((root / "wavs" / f"{name}.wav").read_bytes())
    (data / "wavs" / "LJ050-0002.wav").write_bytes(b"not a wav")
    (data / "metadata.csv").write_text("\n".join(f"LJ050-000{i}|t|Some text." for i in range(3)))
    cfg = load_config(None, [f"path.data={data}", f"path.preprocessed={tmp_path / 'a'}",
                             "runtime.use_pallas_mel=true"])
    pp.preprocess(cfg, device="cpu")
    assert sorted(p.stem for p in (tmp_path / "a").glob("*.npz")) == ["LJ050-0000", "LJ050-0001"]

    def broken(*args, **kwargs):
        raise RuntimeError("log-mel kernel failed to launch")

    monkeypatch.setattr("transformertts_tpu_torch.ops.stft.log_mel", broken)
    cfg = load_config(None, [f"path.data={data}", f"path.preprocessed={tmp_path / 'b'}",
                             "runtime.use_pallas_mel=true"])
    with pytest.raises(RuntimeError, match="failed to launch"):
        pp.preprocess(cfg, device="cpu")
    assert not list((tmp_path / "b").glob("*.npz"))


def test_preprocess_defaults_to_the_gpu(corpus, tmp_path, monkeypatch):
    root, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(None, [f"path.data={root}", f"path.preprocessed={tmp_path / 'c'}"])
    assert cfg.runtime.use_pallas_mel  # the port's default, unlike the JAX package's
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pp.preprocess(cfg)


def test_device_batches_call_log_mel_once_per_chunk_and_pass(corpus, tmp_path, monkeypatch):
    root, _ = corpus
    calls = []

    def counting(y, *args, **kwargs):
        calls.append(tuple(y.shape))
        return log_mel(y, *args, **kwargs)

    monkeypatch.setattr("transformertts_tpu_torch.ops.stft.log_mel", counting)
    monkeypatch.setattr(pp, "_DEVICE_MEL_BATCH", 4)
    cfg = load_config(None, [f"path.data={root}", f"path.preprocessed={tmp_path / 'd'}",
                             "runtime.use_pallas_mel=true"])
    pp.preprocess(cfg, device="cpu")
    chunks = -(-N_CLIPS // 4)
    assert len(calls) == 2 * chunks  # the statistics pass and the saving pass
    assert all(b <= 4 and n % pp._DEVICE_LEN_QUANTUM == 0 for b, n in calls)
    assert len(list((tmp_path / "d").glob("*.npz"))) == N_CLIPS


def test_dataset_split_and_items_match_jax(corpus):
    _, out = corpus
    d = out[("port", False)]
    assert VAL_PREFIXES == ("LJ001", "LJ002", "LJ003")
    for split, n in (("train", N_CLIPS - 4), ("val", 4)):
        ours, theirs = LJSpeechDataset(d, split), JaxDataset(d, split)
        assert len(ours) == len(theirs) == n
        assert [p.name for p in ours.files] == [p.name for p in theirs.files]
        for i in range(n):
            assert ours.lengths(i) == theirs.lengths(i)
            a, b = ours[i], theirs[i]
            assert a["transcript"] == b["transcript"] and a["melspec"].shape[1] == 80
            np.testing.assert_array_equal(a["sequence"], b["sequence"])
            np.testing.assert_array_equal(a["melspec"], b["melspec"])
    with pytest.raises(ValueError, match="bad split"):
        LJSpeechDataset(d, "test")
    assert pick_bucket(5, (4, 8)) == 8 and pick_bucket(9, (4, 8)) is None


LOADER = dict(batch_size=2, phoneme_buckets=(32, 64), mel_buckets=(32, 64), n_mels=80,
              grad_acc_steps=2)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_equal_the_jax_loaders(corpus, shuffle, drop_last):
    _, out = corpus
    d = out[("port", False)]
    kw = dict(LOADER, shuffle=shuffle, drop_last=drop_last, seed=7)
    ours = BucketedLoader(LJSpeechDataset(d, "train"), **kw)
    theirs = JaxLoader(JaxDataset(d, "train"), use_native=False, **kw)
    assert ours.batches_per_epoch() == theirs.batches_per_epoch()
    for epoch in (0, 1):
        a, b = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(a) == len(b) == ours.batches_per_epoch() == (1 if drop_last else 5)
        for x, y in zip(a, b):
            assert set(x) == set(y) == {"phoneme", "melspec", "phoneme_lens", "melspec_lens"}
            for key in x:
                assert x[key].dtype == y[key].dtype
                np.testing.assert_array_equal(x[key], y[key], err_msg=key)
            assert x["melspec"].shape[:2] == (2, 2) and x["melspec"].shape[3] == 80
            assert (np.diff(x["phoneme_lens"], axis=1) <= 0).all()  # sorted, longest first


def test_partial_groups_are_masked(corpus):
    _, out = corpus
    ds = LJSpeechDataset(out[("port", False)], "train")
    loader = BucketedLoader(ds, **dict(LOADER, phoneme_buckets=(64,), mel_buckets=(64,),
                                       batch_size=4, grad_acc_steps=1),
                            shuffle=False, drop_last=False)
    batches = list(loader)
    assert len(batches) == 3  # 10 items in groups of 4
    real = sum(int((b["melspec_lens"] > 0).sum()) for b in batches)
    assert real == len(ds) == 10
    assert int((batches[-1]["melspec_lens"] == 0).sum()) == 2  # repeat-padded rows masked
    assert (batches[-1]["phoneme_lens"] > 0).all()


def test_host_shards_are_disjoint_and_cover_the_schedule(corpus):
    _, out = corpus
    ds = LJSpeechDataset(out[("port", False)], "train")
    kw = dict(LOADER, phoneme_buckets=(64,), mel_buckets=(64,), batch_size=2, grad_acc_steps=1,
              shuffle=True, drop_last=True, seed=3)
    whole = list(BucketedLoader(ds, **dict(kw, batch_size=4)).epoch(0))
    shards = [list(BucketedLoader(ds, process_index=i, process_count=2, **kw).epoch(0))
              for i in (0, 1)]
    assert len(shards[0]) == len(shards[1]) == len(whole) == 2

    def rows(batch):
        return {m.tobytes() for m in batch["melspec"].reshape(-1, 64, 80)}

    for w, a, b in zip(whole, *shards):
        assert a["melspec"].shape == b["melspec"].shape
        assert not rows(a) & rows(b)
        assert rows(a) | rows(b) == rows(w)


def test_prefetch_and_batch_to_device(corpus):
    _, out = corpus
    loader = BucketedLoader(LJSpeechDataset(out[("port", False)], "train"), **LOADER,
                            shuffle=False)
    direct = list(loader.epoch(0))
    fetched = list(prefetch(loader.epoch(0), depth=1))
    assert len(direct) == len(fetched) > 0
    for a, b in zip(direct, fetched):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    t = batch_to_device(fetched[0], "cpu")
    assert t["melspec"].dtype == torch.float32 and t["phoneme"].dtype == torch.int64
    assert t["melspec_lens"].dtype == torch.int64 and t["melspec"].shape == fetched[0]["melspec"].shape

    def failing():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(prefetch(failing()))
