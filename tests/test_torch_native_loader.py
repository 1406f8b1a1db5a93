"""The port's threaded C++ npz reader (``transformertts_tpu_torch/native``)
against the numpy path and the JAX package's loaders.

The reader is built here with the host C++ compiler.  Batches are compared
byte for byte (the same integers and float32 values, copied, never
computed): the reader alone against the port's numpy path on what both
packages' ``preprocess`` wrote; the port's ``BucketedLoader`` on the reader
against the JAX ``BucketedLoader`` on numpy; clipped rows against the JAX
``NativeBatchLoader``.  Then what the reader refuses, and where it builds.
"""

import logging
import shutil

import numpy as np
import pytest

from tests.test_torch_data import LOADER, corpus  # noqa: F401  (fixture)
from transformertts_tpu.data import BucketedLoader as JaxLoader
from transformertts_tpu.data import LJSpeechDataset as JaxDataset
from transformertts_tpu.native import NativeBatchLoader as JaxNativeBatchLoader
from transformertts_tpu_torch import _build
from transformertts_tpu_torch.data import BucketedLoader, LJSpeechDataset
from transformertts_tpu_torch.native import NativeBatchLoader, NativeReadError, bindings

KEYS = ("phoneme", "melspec", "phoneme_lens", "melspec_lens")


def assert_same_bytes(a: dict, b: dict):
    assert set(a) == set(b) == set(KEYS)
    for key in KEYS:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        assert a[key].tobytes() == b[key].tobytes(), key


def copy_split(src, dst):
    """The train split of ``src`` in ``dst``, length index included."""
    dst.mkdir()
    for p in src.glob("*.npz"):
        if not p.stem.startswith(("LJ001", "LJ002", "LJ003")):
            shutil.copy(p, dst / p.name)
    return sorted(dst.glob("*.npz"))


@pytest.mark.parametrize("written_by", [("port", False), ("jax", False), ("port", True)],
                         ids=lambda w: f"{w[0]}-mel{int(w[1])}")
def test_reader_equals_the_numpy_path(corpus, written_by):  # noqa: F811
    _, out = corpus
    ds = LJSpeechDataset(out[written_by], "train")
    idxs = list(range(len(ds)))[::-1]
    native = NativeBatchLoader(ds.files, n_threads=3).load_batch(np.asarray(idxs), 64, 96, 80)
    plain = BucketedLoader(ds, batch_size=2, phoneme_buckets=(64,), mel_buckets=(96,),
                           use_native=False)._read_numpy(idxs, 64, 96)
    assert_same_bytes(native, plain)
    assert (native["melspec_lens"] > 0).all()


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)], ids=lambda s: f"host{s[0]}of{s[1]}")
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_on_the_reader_equals_the_jax_loader(corpus, shuffle, drop_last, shard):  # noqa: F811
    _, out = corpus
    d = out[("port", False)]
    kw = dict(LOADER, shuffle=shuffle, drop_last=drop_last, seed=7, process_index=shard[0],
              process_count=shard[1], batch_size=2 // shard[1])
    ours = BucketedLoader(LJSpeechDataset(d, "train"), use_native=True, n_threads=2, **kw)
    theirs = JaxLoader(JaxDataset(d, "train"), use_native=False, **kw)
    assert ours.reader == "native"
    n = ours.batches_per_epoch()
    assert n == theirs.batches_per_epoch() > 0
    for epoch in (0, 1):
        a, b = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(a) == len(b) == n
        for x, y in zip(a, b):
            assert_same_bytes(x, y)
    assert ours.reads == {"native": 2 * n * LOADER["grad_acc_steps"], "numpy": 0}


@pytest.mark.parametrize("bp, bm", [(4, 8), (1, 1), (200, 3)])
def test_clipping_equals_the_jax_reader(corpus, bp, bm):  # noqa: F811
    _, out = corpus
    ds = LJSpeechDataset(out[("port", False)], "train")
    idxs = np.arange(len(ds), dtype=np.int32)
    ours = NativeBatchLoader(ds.files).load_batch(idxs, bp, bm, 80)
    theirs = JaxNativeBatchLoader(ds.files).load_batch(idxs, bp, bm, 80)
    assert_same_bytes(ours, theirs)
    np.testing.assert_array_equal(ours["phoneme_lens"], [min(bp, ds.lengths(i)[0]) for i in idxs])
    np.testing.assert_array_equal(ours["melspec_lens"], [min(bm, ds.lengths(i)[1]) for i in idxs])


def test_int64_sequences_read_as_numpy_reads_them(corpus, tmp_path):  # noqa: F811
    _, out = corpus
    files = copy_split(out[("port", False)], tmp_path / "d")
    for p in files[::2]:
        z = dict(np.load(p))
        np.savez(p, **{**z, "sequence": z["sequence"].astype(np.int64)})
    ds = LJSpeechDataset(tmp_path / "d", "train")
    idxs = list(range(len(ds)))
    native = NativeBatchLoader(ds.files).load_batch(np.asarray(idxs), 64, 64, 80)
    plain = BucketedLoader(ds, 2, (64,), (64,), use_native=False)._read_numpy(idxs, 64, 64)
    assert_same_bytes(native, plain)


def test_compressed_member_reads_with_numpy_under_auto_and_raises_under_true(
        corpus, tmp_path, caplog):  # noqa: F811
    _, out = corpus
    files = copy_split(out[("port", False)], tmp_path / "d")
    z = dict(np.load(files[3]))
    np.savez_compressed(files[3], **z)
    kw = dict(LOADER, shuffle=False, drop_last=False)
    reference = list(JaxLoader(JaxDataset(tmp_path / "d", "train"), use_native=False, **kw))

    auto = BucketedLoader(LJSpeechDataset(tmp_path / "d", "train"), **kw)
    assert auto.reader == "native"
    with caplog.at_level(logging.WARNING, logger="transformertts_tpu_torch.data"):
        got = list(auto)
    assert auto.reader == "numpy" and auto.reads["numpy"] > 0
    assert any(files[3].name in r.getMessage() and "compressed" in r.getMessage()
               for r in caplog.records if r.levelno == logging.WARNING)
    for x, y in zip(got, reference, strict=True):
        assert_same_bytes(x, y)

    strict = BucketedLoader(LJSpeechDataset(tmp_path / "d", "train"), use_native=True, **kw)
    with pytest.raises(NativeReadError, match=f"{files[3].name}: error 4, a compressed"):
        list(strict)


@pytest.mark.parametrize("fault", ["truncated", "n_mels", "missing"])
@pytest.mark.parametrize("use_native", ["auto", True])
def test_other_row_errors_raise_in_every_mode(corpus, tmp_path, fault, use_native):  # noqa: F811
    _, out = corpus
    files = copy_split(out[("port", False)], tmp_path / "d")
    ds = LJSpeechDataset(tmp_path / "d", "train")
    n_mels, code = 80, {"truncated": 2, "n_mels": 7, "missing": 1}[fault]
    if fault == "truncated":
        files[0].write_bytes(files[0].read_bytes()[:2000])
    elif fault == "n_mels":
        n_mels = 40
    else:
        files[0].unlink()
    loader = BucketedLoader(ds, **dict(LOADER, n_mels=n_mels, shuffle=False, drop_last=False),
                            use_native=use_native)
    bad = files[0].name if fault != "n_mels" else ".npz"
    with pytest.raises(NativeReadError, match=f"{bad}: error {code}, {bindings.ERRORS[code][:8]}"):
        list(loader)
    assert loader.reader == "native"


def test_no_compiler_reads_with_numpy_under_auto_only(corpus, tmp_path, monkeypatch, caplog):  # noqa: F811
    _, out = corpus
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")  # nothing built there
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    bindings._lib.cache_clear()
    try:
        assert not bindings.native_available()
        ds = LJSpeechDataset(out[("port", False)], "train")
        with caplog.at_level(logging.WARNING, logger="transformertts_tpu_torch.data"):
            loader = BucketedLoader(ds, **LOADER)
        assert loader.reader == "numpy"
        assert any("no-such-compiler-here" in r.getMessage() for r in caplog.records)
        assert len(list(loader)) == loader.reads["numpy"] // LOADER["grad_acc_steps"] > 0
        with pytest.raises(_build.NoHostCompiler, match="no-such-compiler-here"):
            BucketedLoader(ds, use_native=True, **LOADER)
        assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
    finally:
        bindings._lib.cache_clear()


def test_compile_error_raises_in_every_mode(corpus, tmp_path, monkeypatch):  # noqa: F811
    _, out = corpus
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "npz_loader.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(_build, "NATIVE", tmp_path / "src")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    bindings._lib.cache_clear()
    try:
        ds = LJSpeechDataset(out[("port", False)], "train")
        for use_native in ("auto", True):
            with pytest.raises(RuntimeError, match="failed for npz_loader.cpp") as info:
                BucketedLoader(ds, use_native=use_native, **LOADER)
            assert not isinstance(info.value, _build.NoHostCompiler)
        with pytest.raises(RuntimeError, match="failed for npz_loader.cpp"):
            bindings.native_available()
        assert BucketedLoader(ds, use_native=False, **LOADER).reader == "numpy"
    finally:
        bindings._lib.cache_clear()


def test_library_builds_into_the_ports_build_directory(tmp_path, monkeypatch):
    port = _build.NATIVE.parent
    jax_native = port.parent / "transformertts_tpu" / "native"
    before = sorted(p.name for p in [*_build.NATIVE.iterdir(), *jax_native.iterdir()])
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.load_host("npz_loader")
    built = _build.host_library_path("npz_loader")
    assert lib._name == str(built) and built.parent == tmp_path / "build"
    assert built.name.startswith("npz_loader-") and built.suffix == ".so"
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [built.name, built.with_suffix(".log").name])
    assert sorted(p.name for p in [*_build.NATIVE.iterdir(), *jax_native.iterdir()]) == before
    monkeypatch.undo()
    bindings._lib.cache_clear()
    assert bindings._lib()._name == str(port / "_build" / built.name)
