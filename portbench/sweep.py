#!/usr/bin/env python3
"""The knee of an open-loop serving cell, on the chip.

    python3 portbench/sweep.py --workload <cell> --rates 10,15,20 --seconds 20 --seed 7

Runs the cell once per rate in this process and prints, per rate, the 95th
percentile latency, the requests due and served, and the backlog: how much
later the last quarter of the requests finished than the first quarter
(a growing queue shows as a large difference).  The highest rate whose
backlog does not grow is the knee; the cell's rate is written as 0.8 of it.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
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
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    harness.import_program()
    import torch

    device = torch.device("cuda", 0)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell = copy.deepcopy(harness.cell_spec(args.workload))
        cell["params"]["rate_per_s"] = rate
        rec = harness.run_cell(args.workload, args.seed, args.seconds, False, device, time.time(),
                               cell_override=cell)
        lat = rec["latency_ms"]
        q = max(1, len(lat) // 4)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat), "failed": rec["failed"],
            "p50_ms": harness.percentile(lat, 50), "p95_ms": harness.percentile(lat, 95),
            "first_quarter_mean_ms": statistics.mean(lat[:q]),
            "last_quarter_mean_ms": statistics.mean(lat[-q:]),
            "rows_per_batch": rec["batcher"]["n_requests"] / max(1, rec["batcher"]["n_batches"]),
            "correct": all(c["ok"] for c in rec["checks"].values()),
        }), flush=True)
        harness.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
