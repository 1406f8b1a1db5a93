#!/usr/bin/env python3
"""The cost of the port's spans (``transformertts_tpu_torch/utils/trace.py``)
on this host: ns per span with no profiler running and under a running
``torch.profiler`` (CPU and CUDA activities), ns per decode step for the
stop readback's two clock reads, and ns per ``record_function`` with no
profiler, which the spans avoid.  Prints one JSON line.

With ``--cell`` it runs one cell of the benchmark instead, as
``portbench/run.py ... --trace 1`` does, but with the decode loop's
per-step ``decode.step`` ranges left out: set its ``device_idle.*`` and
``breakdown`` beside a plain traced run of the same seed.

    python probes/trace_cost.py
    python probes/trace_cost.py --cell ljspeech.stream-b1 --seed 7 --seconds 30
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _per_call_ns(fn, n: int) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


def costs() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from transformertts_tpu_torch.utils import trace

    def one_span():
        with trace.span("probe.span"):
            pass

    def clock_pair():
        t0 = time.perf_counter_ns()
        return time.perf_counter_ns() - t0

    def nothing():
        return 0

    def one_record_function():
        with torch.profiler.record_function("probe.rf"):
            pass

    out = {"device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"}
    for _ in range(2):  # the second reading counts: the first warms the interpreter
        out["span_ns_profiler_off"] = _per_call_ns(one_span, 200_000)
        base = _per_call_ns(nothing, 1_000_000)
        out["readback_clock_ns_per_step"] = _per_call_ns(clock_pair, 1_000_000) - base
        out["profiling_flag_ns"] = _per_call_ns(trace.profiling, 1_000_000) - base
        out["record_function_ns_profiler_off"] = _per_call_ns(one_record_function, 50_000)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        out["span_ns_profiler_on"] = _per_call_ns(one_span, 20_000)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cell")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    if not args.cell:
        print(json.dumps(costs()), flush=True)
        return 0
    from portbench import run
    from transformertts_tpu_torch.utils import trace

    trace.step_range = lambda name: contextlib.nullcontext()  # no per-step ranges
    return run.main(["--workload", args.cell, "--seed", str(args.seed), "--seconds",
                     str(args.seconds), "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
