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

The host code of ``native/<name>.cpp`` (the npz batch reader) is built the
same way with the host C++ compiler (``$CXX``, else ``c++`` or ``g++``) into
``_build/<name>-<hash>.so``: ``load_host``.
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
NATIVE = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

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


def _compile(jobs: list[tuple[list[str], Path]]) -> None:
    """Run each (compiler command, library) job at once, each into a
    temporary file renamed into place, with the compiler's output kept
    beside the library as ``.log``.  Raises on a failure."""
    running = []
    for cmd, out in jobs:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((cmd, proc, tmp, out))
    failed = []
    for cmd, proc, tmp, out in running:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{Path(cmd[0]).name} failed for {Path(cmd[-1]).name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every library of ``names`` (default: all sources) that is
    not built yet, one nvcc per source in parallel.  Raises on a failure."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    _compile([([_nvcc(), *NVCC_FLAGS, str(CSRC / f"{name}.cu")], library_path(name))
              for name in names if not library_path(name).exists()])
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library of ``ops/csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return _loaded[name]


class NoHostCompiler(RuntimeError):
    """Neither ``$CXX`` nor, with it unset, ``c++`` or ``g++`` is on ``PATH``."""


def _cxx() -> str:
    names = [os.environ["CXX"]] if os.environ.get("CXX") else ["c++", "g++"]
    for name in names:
        found = shutil.which(name)
        if found is not None:
            return found
    raise NoHostCompiler(f"no host C++ compiler: {' or '.join(names)} not found (set CXX)")


def host_library_path(name: str) -> Path:
    """Where ``native/<name>.cpp`` is built, keyed by the source and the flags."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update((NATIVE / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The built library of ``native/<name>.cpp``, building it with the host
    compiler if needed.  Raises ``NoHostCompiler`` when a build is needed
    and no compiler exists, ``RuntimeError`` when the compiler fails."""
    with _lock:
        out = host_library_path(name)
        if str(out) not in _loaded:
            if not out.exists():
                _compile([([_cxx(), *HOST_FLAGS, str(NATIVE / f"{name}.cpp")], out)])
            _loaded[str(out)] = ctypes.CDLL(str(out))
        return _loaded[str(out)]
