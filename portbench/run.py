#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on the device it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up (weights and inputs from ``--seed``), warms up every shape the
cell's traffic uses, measures for ``--seconds``, checks what the timed
path produced against the plain reference in ``portbench/reference/``, and
prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks``: each compared number beside its limit, also the last lines on
standard error).  Exits with another code than 0, and prints no result,
without enough CUDA devices, outside a checkout of the program, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

T_IMPORT = time.time()
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = min(harness.process_start(), T_IMPORT)
    try:
        for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                         ("CUDA_CACHE_PATH", "cuda")):
            os.environ[var] = str(harness.CACHE / sub)
        spec = harness.benchmark_spec()
        chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), 1)
        harness.cell_spec(args.workload)  # refuses an unknown cell before any import
        harness.import_program()
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise harness.HarnessError(
                f"the cell needs {chips} CUDA device(s); torch.cuda.is_available() = "
                f"{torch.cuda.is_available()}, device_count() = {torch.cuda.device_count()}", 3)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        rec = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                               t_start)
        out = harness.result_line(args.workload, rec, bool(args.trace), device, spec)
        banned = harness.banned_modules()
        if banned:
            raise harness.HarnessError(f"loaded in this process: {', '.join(banned)}", 4)
    except harness.HarnessError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    except Exception:  # noqa: BLE001 - a run that fails prints its traceback and no result
        traceback.print_exc()
        return 1
    print(f"portbench: done at {time.time() - t_start:.1f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
