"""Times the barriers and the weight stream the decode-step kernel could use.

    python3 probes/decode_barriers.py

Needs one Hopper GPU and nvcc.  Builds ``decode_barriers.cu`` beside this
file into ``transformertts_tpu_torch/_build/`` and prints, for the card that
nvidia-smi names: microseconds per grid barrier over 132 cooperative blocks
(and 66) in four forms, per ``barrier.cluster`` round over one cluster of 16
and of 8 blocks, and per pull of 5.75 MB (``Config()``) and 44.1 MB
(``configs/paper.yaml``) of bf16 weights into 132 and into 16 blocks by
``cp.async.bulk`` (warm in L2).  PERF.md quotes its output.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

here = Path(__file__).resolve().parent
sys.path.insert(0, str(here.parent))
from transformertts_tpu_torch import _build  # noqa: E402

_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
so = _build.BUILD_DIR / "decode_barriers_probe.so"
flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
subprocess.run([_build._nvcc(), *flags, "-o", str(so), str(here / "decode_barriers.cu")],
               check=True)
lib = ctypes.CDLL(str(so))
for fn in (lib.probe_grid, lib.probe_variant, lib.probe_cluster, lib.probe_stream):
    fn.restype = ctypes.c_float
lib.probe_stream.argtypes = [ctypes.c_int, ctypes.c_long, ctypes.c_int]
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip())


def runs(fn, *args):
    return ", ".join(f"{fn(*args):.3f}" for _ in range(3))


for blocks in (132, 66):
    print(f"[probe] grid barrier, {blocks} blocks x 256 threads: "
          f"{runs(lib.probe_grid, blocks, 20000)} us per barrier")
for v, what in ((1, "fence + relaxed atomicAdd (cooperative groups' form)"),
                (2, "red.release arrivals gathered by block 0"),
                (3, "a flag per block polled by block 0's warp"),
                (4, "red.release arrivals on a counter every block polls")):
    print(f"[probe] grid barrier variant {v}, {what}, 132 blocks: "
          f"{runs(lib.probe_variant, 132, 20000, v)} us per barrier")
for cl in (16, 8):
    print(f"[probe] barrier.cluster, one cluster of {cl} blocks (+1 DSMEM store a round): "
          f"{runs(lib.probe_cluster, cl, 20000)} us per barrier")
for nbytes, what in ((5.75e6, "Config() bf16 step weights"),
                     (44.1e6, "paper.yaml bf16 step weights")):
    for blocks in (132, 16):
        us = [lib.probe_stream(blocks, int(nbytes), 50) for _ in range(3)]
        print(f"[probe] {what} ({nbytes / 1e6:.2f} MB) by cp.async.bulk into {blocks} blocks: "
              + ", ".join(f"{u:.2f}" for u in us)
              + f" us per pass ({nbytes / min(us) / 1e6:.2f} TB/s)")
