"""ctypes bindings of the threaded npz batch reader (``npz_loader.cpp``).

The library is built at first use with the host C++ compiler into
``_build/npz_loader-<hash>.so`` (``_build.load_host``) and called through
``ctypes.CDLL``, which releases the GIL for the call: the reads run beside
the Python threads.  Nothing here falls back: no host compiler raises
``_build.NoHostCompiler``, a compile error ``RuntimeError``, and a row the
reader cannot read ``NativeReadError`` naming the file and the reason.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path

import numpy as np

from transformertts_tpu_torch import _build

# npz_loader.cpp's ReadError codes: change both together
ERRORS = {
    1: "the file cannot be opened or read",
    2: "not a ZIP archive as np.savez writes it (no end record, or a damaged or zip64 directory)",
    3: "no sequence.npy or melspec.npy member",
    4: "a compressed (deflated) member, as np.savez_compressed writes",
    5: "a damaged .npy member (header, or data past its end)",
    6: "sequence is not a 1-D little-endian int32 or int64 array",
    7: "melspec is not a C-order little-endian float32 (n_mels, T) array",
}
DEFLATED = 4


class NativeReadError(RuntimeError):
    """Rows the reader could not read: ``failures`` lists (path, code)."""

    def __init__(self, failures: list[tuple[str, int]]):
        self.failures = failures
        super().__init__("native npz reader: " + "; ".join(
            f"{path}: error {code}, {ERRORS.get(code, 'unknown')}" for path, code in failures))

    @property
    def deflated_only(self) -> bool:
        """Every failed row holds a compressed member, which numpy reads."""
        return all(code == DEFLATED for _, code in self.failures)


def _array(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_host("npz_loader")
    lib.ds_open.restype = ctypes.c_void_p
    lib.ds_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
    lib.ds_close.restype = None
    lib.ds_close.argtypes = [ctypes.c_void_p]
    lib.ds_load_batch.restype = None
    lib.ds_load_batch.argtypes = [
        ctypes.c_void_p, _array(np.int32), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _array(np.int32), _array(np.float32), _array(np.int32), _array(np.int32),
        ctypes.c_int, _array(np.int32),
    ]
    return lib


def native_available() -> bool:
    """Whether the reader runs here: False only when it needs a build and no
    host C++ compiler exists.  A compile error raises."""
    try:
        _lib()
    except _build.NoHostCompiler:
        return False
    return True


class NativeBatchLoader:
    """Reads padded (n, bp) phoneme / (n, bm, n_mels) mel batches of the
    files ``paths`` on ``n_threads`` threads (at least one)."""

    def __init__(self, paths: list[str | Path], n_threads: int = 4):
        self._lib = _lib()
        self.paths = [str(p) for p in paths]
        self.n_threads = n_threads
        self._c_paths = (ctypes.c_char_p * len(self.paths))(*map(os.fsencode, self.paths))
        self._handle = self._lib.ds_open(self._c_paths, len(self.paths))

    def load_batch(self, indices: np.ndarray, bp: int, bm: int, n_mels: int) -> dict:
        """Rows ``indices`` of ``paths``: sequences clipped at ``bp`` and
        mels at ``bm`` frames, zero-padded, with their lengths."""
        if self._handle is None:
            raise ValueError("NativeBatchLoader is closed")
        indices = np.ascontiguousarray(indices, np.int32)
        if indices.ndim != 1 or (len(indices) and not (
                0 <= indices.min() and indices.max() < len(self.paths))):
            raise IndexError(f"indices must be 1-D within [0, {len(self.paths)})")
        if min(bp, bm, n_mels) < 1:
            raise ValueError(f"bp, bm and n_mels must be positive, got {(bp, bm, n_mels)}")
        n = len(indices)
        phoneme = np.empty((n, bp), np.int32)
        mel = np.empty((n, bm, n_mels), np.float32)
        p_lens = np.empty((n,), np.int32)
        m_lens = np.empty((n,), np.int32)
        errors = np.empty((n,), np.int32)
        self._lib.ds_load_batch(self._handle, indices, n, bp, bm, n_mels, phoneme, mel,
                                p_lens, m_lens, self.n_threads, errors)
        bad = np.flatnonzero(errors)
        if len(bad):
            raise NativeReadError([(self.paths[indices[r]], int(errors[r])) for r in bad])
        return {"phoneme": phoneme, "melspec": mel, "phoneme_lens": p_lens,
                "melspec_lens": m_lens}

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ds_close(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
