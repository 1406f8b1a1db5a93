"""Where the bf16 fused-FFN forward spends its time, on the card.

    python3 probes/ffn_fwd.py

Needs one Hopper GPU and nvcc.  At the training path's two shapes (N 12,288
and 2,048 rows, D 256, F 1,024, dropout 0.1 and 0):

1. device time by kernel (the weights' staging kernel and ``ffn_fwd_tc``,
   ``torch.profiler`` over 20 calls) for every cluster split ``fsplit`` of
   1, 2, 4 and 8, the plan's own choice marked: what ``fwd_plan``'s cost
   model is calibrated on;
2. the timeline of one block (block 0 of the grid, at the plan's split): a
   copy of ``fused_ffn.cu`` that stamps the global timer at its phases (x
   landed; per slice the weights landed, hp's products done, the epilogue
   done, y's products done; the cluster reduction's barriers and stores) is
   built beside the library in ``transformertts_tpu_torch/_build/`` and run
   in its place.

Prints microseconds with the card's name and power limit.  PERF.md quotes
its output.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

here = Path(__file__).resolve().parent
sys.path.insert(0, str(here.parent))
import chip_smoke as cs  # noqa: E402
from transformertts_tpu_torch import _build  # noqa: E402
from transformertts_tpu_torch.ops import fused_ffn as ffn  # noqa: E402

D, F, SHAPES = 256, 1024, (12288, 2048)


def by_kernel(call, n=20):
    """Device microseconds per call of each kernel ``call`` launches."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = "staging" if "stage_weights" in e.name else "ffn_fwd_tc" if "fwd_tc" in e.name else e.name
            out[k] = out.get(k, 0.0) + (getattr(e, "device_time", None) or e.cuda_time) / n
    return out


def stamped_library():
    """fused_ffn.cu with global-timer stamps at block 0's phases, built."""
    d = _build.BUILD_DIR / "ffn_fwd_probe"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    src = (d / "fused_ffn.cu").read_text()
    edits = [
        ("struct FwdArgs {", "__device__ unsigned long long g_stamps[2][80];\n"
         "#define STAMP(k) do { if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && "
         "tid == 0) g_stamps[wg][k] = global_timer_ns(); } while (0)\nstruct FwdArgs {"),
        ("  const size_t rec = fwd_record_bytes(S, a.Dp, a.n_dg);\n",
         "  const size_t rec = fwd_record_bytes(S, a.Dp, a.n_dg);\n  STAMP(0);\n"),
        ("  __syncthreads();  // x landed; the mbarriers are initialised\n",
         "  __syncthreads();  // x landed; the mbarriers are initialised\n  STAMP(1);\n"),
        ("      mbar_wait(&full[st], (t / a.stages) & 1);\n",
         "      mbar_wait(&full[st], (t / a.stages) & 1);\n      if (t < 16) STAMP(2 + 4 * t);\n"),
        ("      fence_regs(hp);\n      if (R == 2 && wg == 0 && s == s0)",
         "      fence_regs(hp);\n      if (t < 16) STAMP(3 + 4 * t);\n      if (R == 2 && wg == 0 && s == s0)"),
        ("      wgmma_fence();\n      const uint64_t dw2 = make_desc<S>(w2s);\n",
         "      if (t < 16) STAMP(4 + 4 * t);\n      wgmma_fence();\n      const uint64_t dw2 = make_desc<S>(w2s);\n"),
        ("      wgmma_wait<0>();\n      release(s);\n",
         "      wgmma_wait<0>();\n      if (t < 16) STAMP(5 + 4 * t);\n      release(s);\n"),
        ("  if (a.fsplit > 1) cluster_sync();\n  else __syncthreads();\n  float* red",
         "  STAMP(66);\n  if (a.fsplit > 1) cluster_sync();\n  else __syncthreads();\n  STAMP(67);\n  float* red"),
        ("  if (a.fsplit > 1) cluster_sync();  // every partial has landed\n  else __syncthreads();\n",
         "  STAMP(68);\n  if (a.fsplit > 1) cluster_sync();  // every partial has landed\n"
         "  else __syncthreads();\n  STAMP(69);\n"),
        ('extern "C" {', 'extern "C" {\nint tts_probe_stamps(unsigned long long* out) {\n'
         '  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)));\n}'),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"probe out of date with fused_ffn.cu: {old[:60]!r}")
        src = src.replace(old, new)
    (d / "fused_ffn.cu").write_text(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-o", str(d / "lib.so"), str(d / "fused_ffn.cu")],
                   check=True)
    return ctypes.CDLL(str(d / "lib.so"))


def main():
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    plan = ffn.fwd_plan
    inputs = {n: cs.ffn_inputs(n, D, F, torch.bfloat16, dev, seed=n)[:5] for n in SHAPES}
    rows = {n: ffn.pick_rows(n, D, F, 2) for n in SHAPES}
    for n in SHAPES:
        for fs in (1, 2, 4, 8):
            ffn.fwd_plan = lambda *a, fs=fs: dict(plan(*a), fsplit=fs, grid=(fs,) + plan(*a)["grid"][1:])
            for p in (0.1, 0.0):
                t = by_kernel(lambda: ffn.fused_ffn_forward(*inputs[n], 99, p, rows[n]))
                mark = " (the plan's)" if fs == plan(n, D, F)["fsplit"] else ""
                print(f"N={n} fsplit={fs}{mark} p={p}: staging {t['staging']:.1f} us, "
                      f"ffn_fwd_tc {t['ffn_fwd_tc']:.1f} us [{card}]", flush=True)
        ffn.fwd_plan = plan
    lib = stamped_library()
    _build._loaded["fused_ffn"] = lib
    for n in SHAPES:
        ffn.fused_ffn_forward(*inputs[n], 99, 0.1, rows[n])
        torch.cuda.synchronize()
        stamps = (ctypes.c_ulonglong * 160)()
        if lib.tts_probe_stamps(stamps) != 0:
            raise SystemExit("could not read the stamps")
        a = np.array(stamps, dtype=np.int64).reshape(2, 80)
        t0 = a[:, 0].min()
        pl = plan(n, D, F)
        n_slices = len(ffn.fwd_parts(pl["slices"], pl["fsplit"])[0])
        print(f"N={n} p=0.1, grid {pl['grid']}: block 0's timeline, us from its start, first "
              f"three and last of its {n_slices} slices [{card}]")
        for w in range(2):
            at = lambda k: (a[w, k] - t0) / 1e3  # noqa: E731
            done = sorted({0, 1, 2, min(n_slices, 16) - 1})
            print(f"  warpgroup {w}: x landed {at(1):.2f}; " + "; ".join(
                f"slice {t}: weights {at(2 + 4 * t):.2f}, hp {at(3 + 4 * t):.2f}, "
                f"epilogue {at(4 + 4 * t):.2f}, y {at(5 + 4 * t):.2f}" for t in done)
                + f"; reduction: barrier {at(66):.2f}-{at(67):.2f}, stores to {at(68):.2f}, "
                f"barrier to {at(69):.2f}")


if __name__ == "__main__":
    main()
