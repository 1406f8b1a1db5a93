"""Where the log-mel FFT kernel spends its time, on the card.

    python3 probes/log_mel_fft.py

Needs one Hopper GPU and nvcc.  Builds copies of ``log_mel.cu`` with one
phase of the FFT kernel taken out (the mel sums, the FFT stages, the split
step and magnitudes, or both of the last), each beside the library in
``transformertts_tpu_torch/_build/``, and times each in the library's place
at the batch preprocessing sends (32 signals of 163,840 samples, n_fft
1,024, hop 256, 80 bands): device time per call by CUDA-graph replay, with
the card's name and power limit.  The differences are what each phase
costs.  PERF.md quotes its output.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

here = Path(__file__).resolve().parent
sys.path.insert(0, str(here.parent))
import chip_smoke as cs  # noqa: E402
from transformertts_tpu_torch import _build  # noqa: E402
from transformertts_tpu_torch.ops import stft  # noqa: E402

MEL = "    for (int c = lane; c < n_mels; c += 32) {"
FFT = "    fft_stages<M, 1>(re, im, sig + f * hop, win, tws, lane);\n"
SPLIT = "    for (int k = lane; k <= M; k += 32) {"
VARIANTS = {
    "whole kernel": [],
    "no mel sums": [(MEL, MEL.replace("c < n_mels", "c < 0"))],
    "no FFT stages": [(FFT, "")],
    "no split step": [(SPLIT, SPLIT.replace("k <= M", "k < 0"))],
    "no split, no mel sums": [(MEL, MEL.replace("c < n_mels", "c < 0")),
                              (SPLIT, SPLIT.replace("k <= M", "k < 0"))],
}


def main():
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = _build.BUILD_DIR / f"log_mel_probe_{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        src = (d / "log_mel.cu").read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"probe out of date with log_mel.cu: {old[:60]!r}")
            src = src.replace(old, new)
        (d / "log_mel.cu").write_text(src)
        jobs[name] = (d, subprocess.Popen([_build._nvcc(), *flags, "-o", str(d / "lib.so"),
                                           str(d / "log_mel.cu")], stderr=subprocess.DEVNULL))
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    rng = np.random.default_rng(9)
    clips = [cs.clip_signal(rng, int(n))
             for n in rng.integers(44100, cs.MEL_BUCKET_LEN - 1024, cs.MEL_BATCH)]
    y = torch.from_numpy(cs.padded_batch(clips, cs.MEL_BUCKET_LEN)).to(dev)
    a = cs.AUDIO
    consts = stft._fft_constants(a["sample_rate"], a["n_fft"], a["win_length"], a["n_mels"],
                                 a["fmin"], a["fmax"], dev)
    n_frames = 1 + (cs.MEL_BUCKET_LEN - a["n_fft"]) // a["hop_length"]
    for name, (d, proc) in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for the {name!r} copy")
        _build._loaded["log_mel"] = ctypes.CDLL(str(d / "lib.so"))
        ms = cs.device_ms(lambda: stft.log_mel_fft_forward(y, n_frames, *consts, a["hop_length"]),
                          n=4, reps=3)
        print(f"log_mel FFT kernel, {name}: {ms * 1e3:.1f} us [{card}]", flush=True)


if __name__ == "__main__":
    main()
