"""The bf16 fused-FFN kernels (PERF.md rows 7-8) with the mask's global row
and column map, against the version without it, in one process on the card.

    python3 probes/ffn_mask_variants.py [PARENT_CSRC]

Needs one Hopper GPU and nvcc.  Builds ``ops/csrc/fused_ffn.cu`` as it is
("map"), two variants of it made by exact string replacement, and, when
given, the ``fused_ffn.cu`` of an earlier tree that takes no map
("before", called with its own argument list), all with
``_build.NVCC_FLAGS`` at once; prints each library's registers of
``ffn_fwd_tc<64, 4>``, the SASS instructions of its slice epilogue (as the
build phase of ``chip_smoke.py`` counts them), and the device time per
call (CUDA-graph replay) of the forward and the backward at PERF.md's
shape (N 12,288, D 256, F 1,024, dropout 0.1) at offset 0, the variants in
turns (each twice), with the card's name and power limit.  The variants:

- "branch": the map's division only when the call's rows are a time
  slice (a branch the same for every thread);
- "no-map": the mask's per-row constants as before the map (the row
  itself, the call's own d_ffn), the map's fields left in the struct.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

here = Path(__file__).resolve().parent
sys.path.insert(0, str(here.parent))
import chip_smoke as cs  # noqa: E402
from transformertts_tpu_torch import _build  # noqa: E402
from transformertts_tpu_torch.ops import fused_ffn as ffn  # noqa: E402

N, D, F, P = 12288, 256, 1024, 0.1
MAP_LINE = "  const int g = (row / mk.t_local) * mk.t_total + row % mk.t_local + mk.row_off;"
EDITS = {
    "branch": [(MAP_LINE, "  const int g = mk.t_local == mk.t_total ? row + mk.row_off\n"
                          "                                         : (row / mk.t_local) * "
                          "mk.t_total + row % mk.t_local + mk.row_off;")],
    "no-map": [(MAP_LINE, "  const int g = row;"),
               ("static_cast<uint32_t>(mk.f_total) +\n         static_cast<uint32_t>(mk.col_off);",
                "static_cast<uint32_t>(mk.f_total);")],
}


def sources(out: Path, parent) -> dict:
    """{variant: directory holding its csrc copy}."""
    dirs = {"map": _build.CSRC}
    for name, edits in EDITS.items():
        d = out / name
        shutil.copytree(_build.CSRC, d, dirs_exist_ok=True)
        text = (d / "fused_ffn.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} found {text.count(old)} times")
            text = text.replace(old, new)
        (d / "fused_ffn.cu").write_text(text)
        dirs[name] = d
    if parent:
        dirs["before"] = Path(parent)
    return dirs


def build(dirs: dict, out: Path) -> dict:
    """{variant: (library, ptxas report)}, every nvcc at once."""
    jobs = {}
    for name, d in dirs.items():
        lib = out / f"fused_ffn-{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / "fused_ffn.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        built[name] = (lib, log)
    return built


def epilogue(lib: Path) -> str:
    sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    fn, body = None, {}
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            body[fn] = []
        elif fn is not None and "/*" in ln and ";" in ln:
            body[fn].append(ln)
    for fn, lines in body.items():
        if "ffn_fwd_tc" in fn and "ILi64E" in fn:
            at = [i for i, ln in enumerate(lines) if "HGMMA" in ln]
            gap = max(b - a - 1 for a, b in zip(at, at[1:]))
            return f"{len(lines)} SASS instructions, epilogue {gap} ({gap / 32:.1f} an element)"
    return "ffn_fwd_tc<64> not found"


def registers(report: str) -> str:
    rows = cs.ptxas_kernels(report)
    for short, (_, regs, _) in zip(cs.demangle([r[0] for r in rows]), rows):
        if short.startswith("ffn_fwd_tc<64"):
            return f"{regs} registers"
    return "?"


def calls(name: str, lib, x, w1, b1, w2, b2, dy, rows_m):
    """(forward, backward) closures on the loaded library ``lib``."""
    if name != "before":  # the map's argument list: the port's wrappers, on this library
        def use(fn):
            def call():
                _build._loaded["fused_ffn"] = lib
                return fn()
            return call

        return (use(lambda: ffn.fused_ffn_forward(x, w1, b1, w2, b2, 99, P, rows_m)),
                use(lambda: ffn.fused_ffn_backward(x, w1, b1, w2, dy, 99, P, rows_m)))
    i, u, f, p = ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p
    tail = [i, f, u, u, i, p]  # dropout_on, keep_div, threshold, seed, mask_rows, stream
    lib.tts_fused_ffn_fwd_tc.argtypes = [i] * 3 + [p] * 7 + [i, i] + tail
    lib.tts_fused_ffn_bwd_tc.argtypes = [i] * 3 + [p] * 15 + [i] * 4 + tail
    plan, bplan, layout = ffn.fwd_plan(N, D, F), ffn.bwd_plan(N, D, F), ffn.bwd_scratch(N, D, F)
    y, dx = torch.empty_like(x), torch.empty_like(x)
    staged = torch.empty(plan["staged_bytes"], dtype=torch.uint8, device=x.device)
    grads = torch.empty(2 * F * D + F + D, dtype=torch.float32, device=x.device)
    scratch = torch.empty(layout["total"][1], dtype=torch.uint8, device=x.device)

    def mask():  # on the stream current at the call (a graph's capture stream)
        stream = torch.cuda.current_stream().cuda_stream
        return (1, 1.0 - P, ffn.threshold_of(P), 99, rows_m, stream)

    def fwd():
        rc = lib.tts_fused_ffn_fwd_tc(N, D, F, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                      w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                                      staged.data_ptr(), plan["fsplit"], plan["stages"], *mask())
        assert rc == 0, rc

    def bwd():
        rc = lib.tts_fused_ffn_bwd_tc(
            N, D, F, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), grads.data_ptr(),
            *(scratch.data_ptr() + layout[k][0]
              for k in ("w1b", "w2b", "dh", "hd", "pdb1", "pdb2", "pw1", "pw2")),
            bplan["spg"], bplan["fgroups"], bplan["tpc"], bplan["chunks"], *mask())
        assert rc == 0, rc

    return fwd, bwd


def main(argv) -> int:
    card = cs.card_line()
    out = here.parent / "transformertts_tpu_torch" / "_build" / "ffn_variants"
    out.mkdir(parents=True, exist_ok=True)
    built = build(sources(out, argv[1] if len(argv) > 1 else None), out)
    device = torch.device("cuda", 0)
    x, w1, b1, w2, b2, dy = cs.ffn_inputs(N, D, F, torch.bfloat16, device, seed=3)
    rows_m = ffn.pick_rows(N, D, F, 2)
    fns = {name: calls(name, ctypes.CDLL(str(lib)), x, w1, b1, w2, b2, dy, rows_m)
           for name, (lib, _) in built.items()}
    times = {name: [] for name in fns}
    for turn in list(fns) + list(reversed(fns)):
        fwd, bwd = fns[turn]
        times[turn].append((cs.device_ms(fwd, n=10, reps=5), cs.device_ms(bwd, n=10, reps=5)))
    for name, (lib, report) in built.items():
        t = times[name]
        print(f"[ffn-variants] {name}: ffn_fwd_tc<64, 4> {registers(report)}, {epilogue(lib)}; "
              f"forward {' / '.join(f'{a * 1e3:.1f}' for a, _ in t)} us, backward "
              f"{' / '.join(f'{b * 1e3:.1f}' for _, b in t)} us [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
