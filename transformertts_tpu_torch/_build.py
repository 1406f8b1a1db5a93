"""Builds the package's CUDA kernels at first use and loads them with ctypes.

Each ``ops/csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``: nvcc for
``sm_90a`` (Hopper) into a shared library with a plain C interface.  The
hash covers the sources and the flags, so an edited kernel is rebuilt and
an unchanged one is loaded as it is.  ``build()`` starts one nvcc per
source, all at once, and waits for them; the compiler's report (registers,
shared memory, spills: ``-Xptxas -v``) is kept beside each library as
``.log``.  ``_build/`` is listed in ``.gitignore``.

Set ``CUDA_HOME`` where nvcc is not at ``$CUDA_HOME/bin/nvcc`` with the
toolkit's default ``/usr/local/cuda`` nor on ``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "ops" / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``ops/csrc/<name>.cu`` is built, keyed by sources and flags
    (the source, every header, and a ``.cu`` file the source includes)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    main = CSRC / f"{name}.cu"
    included = re.findall(r'#include "(\w+\.cu)"', main.read_text())
    for src in [main, *sorted(CSRC.glob("*.cuh")), *[CSRC / f for f in included]]:
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every library of ``names`` (default: all sources) that is
    not built yet, one nvcc per source in parallel.  Raises on a failure."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library of ``ops/csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return _loaded[name]
