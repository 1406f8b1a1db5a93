"""Why the verify form's fields of ``Step`` are compiled in its library only.

    python3 probes/decode_step_fields.py

Needs nvcc (no GPU).  Builds ``ops/csrc/decode_step.cu`` twice with the
package's nvcc flags, in parallel, into a temporary directory: as it is, and
with the verify form's fields of ``Step`` (``prev`` .. ``r``, guarded by
``TTS_DECODE_STEP_VERIFY``) compiled into the step's library as well; the
kernels' code is the same in both.  Prints every rate-0 kernel's registers
and ptxas spill line in both builds beside ``chip_smoke.DECODE_STEP_PTXAS``
(the step as it was before the verify form), and how many kernels moved.
PERF.md quotes its output.
"""

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from transformertts_tpu_torch import _build  # noqa: E402

GUARD = "#ifdef TTS_DECODE_STEP_VERIFY\n  // the verify pass (kVerify): frame is the true input"
END = "  int limit, r;\n#endif\n};"


def kernels(log: str) -> dict:
    """(type, rows) -> (registers, spill line) of each rate-0 kernel."""
    rows = cs.ptxas_kernels(log)
    out = {}
    for short, (_, regs, spill) in zip(cs.demangle([r[0] for r in rows]), rows):
        t, r = short.split("<")[1].split(",")[:2]
        out[(t.strip(), int(r))] = (regs, spill)
    return out


def main() -> int:
    source = (_build.CSRC / "decode_step.cu").read_text()
    if source.count(GUARD) != 1 or source.count(END) != 1:
        raise SystemExit("decode_step.cu no longer guards the verify fields as this probe expects")
    variants = {"as built": source,
                "fields in the step": source.replace(GUARD, GUARD.split("\n", 1)[1]).replace(
                    END, "  int limit, r;\n};")}
    with tempfile.TemporaryDirectory(prefix="decode_step_fields_") as tmp:
        jobs = {}
        for name, text in variants.items():
            d = Path(tmp) / name.replace(" ", "_")
            d.mkdir()
            for h in _build.CSRC.glob("*.cuh"):
                shutil.copy(h, d)
            (d / "decode_step.cu").write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                   str(d / "decode_step.cu")]
            jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
        logs = {}
        for name, proc in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed for {name}:\n{out}")
            logs[name] = kernels(out)
    for key, want in sorted(cs.DECODE_STEP_PTXAS.items()):
        got = "; ".join(f"{name}: {logs[name].get(key)}" for name in variants)
        print(f"[fields] {key[0]} R={key[1]}: before {want}; {got}")
    for name in variants:
        moved = sum(logs[name].get(k) != v for k, v in cs.DECODE_STEP_PTXAS.items())
        print(f"[fields] {name}: {moved} of {len(cs.DECODE_STEP_PTXAS)} rate-0 kernels moved")
    return 0


if __name__ == "__main__":
    sys.exit(main())
