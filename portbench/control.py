#!/usr/bin/env python3
"""Readings for the limits of a cell's check, on the chip.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 8 [--out FILE]

Runs the cell once per seed in this process (a short window at the cell's
own load and sizes) and prints, per seed, what the check reads of the
program and of the control: the plain reference in the precision below
the configuration's (float8 for bf16) put in the program's place.  The
lower reading of a limit is the program's largest over a dozen seeds or
more, the upper one the control's smallest (for training, or the least of
what the planted faults read: ``--fault``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--out", default=None)
    p.add_argument("--fault", default=None, choices=("unchanged", "half", "altered"),
                   help="plant this fault in the program (faults.py) and read it")
    args = p.parse_args(argv)
    harness.import_program()
    if args.fault:
        from portbench import faults

        faults.plant(args.fault, harness.cell_spec(args.workload)["kind"] == "train")
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.time()
        rec = harness.run_cell(args.workload, seed, args.seconds, False, device, time.time(),
                               control=not args.fault)
        row = {"seed": seed, "fault": args.fault,
               "program": {k: c["value"] for k, c in rec["checks"].items()},
               "loss_gap": rec.get("loss_gap"),
               "control": rec["control"], "attempted": rec["attempted"], "failed": rec["failed"],
               "s": time.time() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
        harness.free_device()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
