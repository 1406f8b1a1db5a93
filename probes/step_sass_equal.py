"""Do two trees' decode-step libraries compile to the same machine code?

    python3 probes/step_sass_equal.py OLD_TREE NEW_TREE

Needs nvcc and cuobjdump (a GPU is not used).  Builds
``ops/csrc/decode_step.cu`` and ``decode_step_dropout.cu`` of both trees
(the package's nvcc flags, all four at once) into
``transformertts_tpu_torch/_build/`` of this checkout, and compares each
kernel's SASS instructions (``cuobjdump -sass``; offsets stripped; kernels
matched by element type, rows and prenet dropout, whatever other template
arguments their names carry).  Prints the count of kernels with equal
instructions per library and exits 1 unless every kernel of both matches.
A change to the shared decode-step source that must leave the step alone
(such as one for the verify kernel) is held to this; ``chip_smoke.py``'s
``DECODE_STEP_PTXAS`` checks registers and spills only.
"""

import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from transformertts_tpu_torch import _build  # noqa: E402

LIBS = ("decode_step", "decode_step_dropout")


def sass(so: Path) -> dict:
    """Instructions of each decode_step_kernel in ``so``, by (type, rows, dropout)."""
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out, key = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            m = re.search(r"decode_step_kernel(I\w+?)Li(\d+)ELb(\d)", name)
            key = m.groups() if m else name
            out[key] = []
        elif key is not None and "/*" in ln and ";" in ln:
            out[key].append(re.sub(r"/\*[0-9a-f]{4}\*/", "", ln.split(";")[0]).strip())
    return out


def main(old: str, new: str) -> int:
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {(tag, lib): (Path(root) / "transformertts_tpu_torch/ops/csrc" / f"{lib}.cu",
                         _build.BUILD_DIR / f"sass_probe_{tag}_{lib}.so")
            for tag, root in (("old", old), ("new", new)) for lib in LIBS}
    with ThreadPoolExecutor(len(jobs)) as ex:
        runs = list(ex.map(lambda j: subprocess.run(
            [_build._nvcc(), *flags, str(j[0]), "-o", str(j[1])], capture_output=True, text=True),
            jobs.values()))
    for (tag, lib), r in zip(jobs, runs):
        if r.returncode:
            print(f"nvcc failed for the {tag} tree's {lib}.cu:\n{r.stderr[-3000:]}")
            return 1
    ok = True
    for lib in LIBS:
        a, b = sass(jobs[("old", lib)][1]), sass(jobs[("new", lib)][1])
        same = sum(a[k] == b.get(k) for k in a)
        print(f"{lib}: {len(a)} old kernels, {len(b)} new kernels, {same} with equal SASS")
        ok &= same == len(a) == len(b)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
