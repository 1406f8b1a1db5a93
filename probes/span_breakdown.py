#!/usr/bin/env python3
"""Where a benchmark cell's time goes by the program's own spans: one run
of the cell (``--trace 0``: no profiler, so the clean stretch is the whole
window), then, over the window's clean traces (``portbench/spans.py``):

- per span name, the mean ms per trace (batch, stream request or
  optimizer step);
- in a serving cell, the harness's own span per batch or request (the
  ``decode_span_s`` behind ``decode.ms_per_step``) beside the sum of the
  program's spans that cover the same stretch;
- in the stream, each request's set-up split into its spans, median ms.

Prints one JSON line.

    python probes/span_breakdown.py --cell ljspeech.stream-b1 --seed 7 --seconds 30
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SETUP = ("synth.g2p", "decode.init", "decode.encode", "decode.cross_kv", "decode.plan")
SYNTH = ("synth.g2p", "decode.init", "decode.loop", "decode.postnet", "synth.deliver")


def breakdown(rec) -> dict:
    from portbench import spans

    traces = spans.clean_traces(rec)
    calls = [g for g in traces.values()
             if g[0].name == "train.step" or any(s.name == "decode.init" for s in g)]
    names = sorted({s.name for g in traces.values() for s in g})
    out = {"traces": len(calls), "per_trace_ms": {
        n: sum(s.ns for g in calls for s in g if s.name == n) / max(len(calls), 1) / 1e6
        for n in names}}
    if "decode_span_s" not in rec:  # training
        return out
    if "first_chunk_ms" in rec:  # the stream: the harness times the chunks after the first
        later = spans.decode_loops(rec)
        firsts = {g[0].trace: next(s.start_ns for s in g if s.name == "decode.postnet")
                  for g in calls}
        covered = [s for g in calls for s in g if s.name in ("decode.loop", "decode.postnet",
                                                              "synth.deliver")
                   and s.start_ns > firsts[g[0].trace]]
        out["later_loops"] = len(later)
        out["setup_ms_median"] = {n: statistics.median(
            sum(s.ns for s in g if s.name == n) / 1e6 for g in calls) for n in SETUP}
        out["first_chunk_ms_median"] = {n: statistics.median(
            sum(s.ns for s in g if s.name == n and s.start_ns <= firsts[g[0].trace]) / 1e6
            for g in calls) for n in ("decode.loop", "decode.postnet", "synth.deliver")}
        program = sum(s.ns for s in covered) / 1e9
    else:
        program = sum(s.ns for g in calls for s in g if s.name in SYNTH and s.parent is not None
                      and any(b.id == s.parent and b.name == "batcher.batch" for b in g)) / 1e9
    out["harness_span_s"] = rec["decode_span_s"]
    out["program_spans_s"] = program
    out["program_over_harness"] = program / rec["decode_span_s"] if rec["decode_span_s"] else None
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cell", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    harness.import_program()
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    rec = harness.run_cell(args.cell, args.seed, args.seconds, False, device,
                           t_start=harness.process_start())
    out = {"cell": args.cell, "seed": args.seed, "device": harness.device_info(device)["kind"],
           "correct": bool(rec["failed"] == 0 and all(c["ok"] for c in rec["checks"].values())),
           **breakdown(rec)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
