"""One run of one cell of the port's benchmark.

The harness finds everything by name: a cell in ``workloads/<cell>.json``
(its configuration, traffic kind and parameters), the configuration in
``configs/<config>.json``, the traffic kind's driver in
``traffic/<kind>.py`` (``run(ctx) -> record``) and each metric's reader in
``metrics/<metric>.py``, or, for a metric named ``<base>.<suffix>``, in
``metrics/<base>.py`` (``read(record) -> float | None``).  Which metrics a
run prints comes from ``BENCHMARK.json``: the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PROGRAM = "transformertts_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "transformertts_tpu")
CACHE = ROOT / ".portbench_cache"  # fixed, inside the checkout


class HarnessError(RuntimeError):
    """A run that cannot print a result; ``code`` is its exit code."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def process_start() -> float:
    """This process's start, on the ``time.time()`` clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def note(ctx, what: str) -> None:
    """A line on standard error: seconds since the process started."""
    print(f"portbench: {what} at {time.time() - ctx.t_start:.1f} s", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def list_cells() -> list[str]:
    return sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))


def cell_spec(name: str) -> dict:
    path = BENCH / "workloads" / f"{name}.json"
    if not path.exists():
        raise HarnessError(f"no cell {name!r}: {path} is missing (cells: {list_cells()})", 2)
    return load_json(path)


def config_spec(name: str) -> dict:
    path = BENCH / "configs" / f"{name}.json"
    if not path.exists():
        raise HarnessError(f"no configuration {name!r}: {path} is missing", 2)
    return load_json(path)


def benchmark_spec() -> dict:
    path = ROOT / "BENCHMARK.json"
    return load_json(path) if path.exists() else {"end_to_end": [], "per_layer": [],
                                                  "workloads": []}


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str):
    path = BENCH / "traffic" / f"{kind}.py"
    if not path.exists():
        raise HarnessError(f"no traffic kind {kind!r}: {path} is missing", 2)
    return _module(path, f"portbench_traffic_{kind.replace('-', '_')}")


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, else the file of
    its name without the last dotted part."""
    name = metric
    while True:
        path = BENCH / "metrics" / f"{name}.py"
        if path.exists():
            return _module(path, "portbench_metric_" + name.replace(".", "_").replace("-", "_"))
        if "." not in name:
            raise HarnessError(f"no reader for metric {metric!r} under {BENCH / 'metrics'}", 2)
        name = name.rsplit(".", 1)[0]


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries of ``BENCHMARK.json`` that a run of ``cell``
    prints: end-to-end ones without ``trace``, per-layer ones with it."""
    e2e = [e for e in spec["end_to_end"] if cell in e.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {e["name"] for e in e2e}
    return [e for e in spec["per_layer"]
            if ((cell in e["workloads"]) if "workloads" in e else (e["moves"] in reported))]


def banned_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in BANNED)


def percentile(values, q: float) -> float | None:
    """The q-th percentile (linear between order statistics)."""
    vals = sorted(values)
    if not vals:
        return None
    pos = (len(vals) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


# ------------------------------------------------------------------ the program


def import_program():
    """The program's package from this checkout, and nothing else."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    try:
        import transformertts_tpu_torch as pkg
    except ImportError as e:
        raise HarnessError(f"the program ({PROGRAM}) is not in {ROOT}: {e}", 5) from e
    if Path(pkg.__file__).resolve().parent.parent != ROOT:
        raise HarnessError(f"{PROGRAM} was imported from {pkg.__file__}, not from {ROOT}", 5)
    return pkg


def program_config(config: dict, runtime: dict | None = None):
    """The program's ``Config`` of a configuration file, with the cell's
    ``runtime`` settings over it."""
    from transformertts_tpu_torch.config import config_from_dict

    sections = {k: dict(config[k]) for k in ("model", "audio", "training", "loss", "runtime")}
    sections["runtime"].update(runtime or {})
    return config_from_dict(sections)


# ------------------------------------------------------------------ device


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", str(device.index or 0)], capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class DeviceProfile:
    """``torch.profiler`` over a stretch of the window: the device's busy
    seconds (union of its operations' intervals), the stretch's length, the
    device time by operation name, and the idle gaps by what the host was
    running.  Only ``key_averages``-sized summaries are kept."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        asked = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - asked

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self) -> dict:
        """busy_s, window_s, by_name {name: [seconds, count]}, breakdown."""
        from torch.autograd import DeviceType

        t_read = time.perf_counter()
        dev, cpu = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                dev.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CPU:
                cpu.append((tr.start, tr.end, e.name))
        if not dev:
            raise HarnessError("the profiler recorded no device operation", 1)
        dev.sort()
        cpu.sort()
        by_name: dict[str, list] = {}
        busy, gaps = 0.0, []
        cur_s, cur_e = dev[0][0], dev[0][1]
        for s, e, name in dev:
            slot = by_name.setdefault(name, [0.0, 0])
            slot[0] += (e - s) * 1e-6
            slot[1] += 1
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s = s
            cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        starts = [c[0] for c in cpu]
        by_host: dict[str, float] = {}
        for g0, g1 in gaps:
            mid, label, best = (g0 + g1) / 2, "host: Python, no operation", None
            i = bisect.bisect_right(starts, mid)
            for s, e, name in cpu[max(0, i - 400): i]:
                if e >= mid and (best is None or e - s < best):
                    label, best = name, e - s
            by_host[label] = by_host.get(label, 0.0) + (g1 - g0) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        print(f"portbench: profiler started in {self.start_s:.3f} s, held {self.t1 - self.t0:.3f} s, "
              f"{len(dev)} device and {len(cpu)} host events read in "
              f"{time.perf_counter() - t_read:.3f} s", file=sys.stderr)
        return {
            "busy_s": busy * 1e-6,
            "window_s": self.t1 - self.t0,
            "by_name": by_name,
            "breakdown": {
                "device_ops": [[n[:160], v[0]] for n, v in top],
                "idle_gaps": [[n[:160], s] for n, s in
                              sorted(by_host.items(), key=lambda kv: -kv[1])[:10]],
            },
        }


def device_seconds(profile: dict, *needles: str) -> tuple[float, int]:
    """Device seconds and launches of the operations whose name holds one
    of ``needles``."""
    sel = [v for name, v in profile["by_name"].items() if any(n in name for n in needles)]
    return sum(v[0] for v in sel), sum(v[1] for v in sel)


# ------------------------------------------------------------------ a run


@dataclasses.dataclass
class Ctx:
    """What a traffic kind's ``run`` gets."""

    name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float  # process start, time.time() clock
    control: bool = False  # read the control beside the program (portbench/control.py)

    @property
    def params(self) -> dict:
        return self.cell["params"]


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             t_start: float | None = None, config_override: dict | None = None,
             control: bool = False, cell_override: dict | None = None) -> dict:
    """Set up, warm up, measure and check one run; returns the record that
    the traffic kind filled (``setup_s``, ``attempted``, ``failed``,
    ``checks`` and what its metrics read)."""
    import torch

    cell = cell_override or cell_spec(name)
    config = config_override or config_spec(cell["config"])
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ctx = Ctx(name, cell, config, int(seed), float(seconds), bool(trace), torch.device(device),
              t_start if t_start is not None else time.time(), control)
    return kind_module(cell["kind"]).run(ctx)


def result_line(name: str, rec: dict, trace: bool, device, spec: dict | None = None) -> dict:
    spec = spec or benchmark_spec()
    metrics = {}
    for entry in cell_metrics(spec, name, trace):
        value = reader(entry["name"]).read(rec)
        if value is None:
            if not trace:
                raise HarnessError(f"end-to-end metric {entry['name']} has no value", 1)
            continue
        metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    dev = device_info(device)
    dev["memory_peak_bytes"] = int(rec.get("memory_peak_bytes", 0))
    if trace and "profile" in rec:
        dev["busy_s"] = rec["profile"]["busy_s"]
        dev["window_s"] = rec["profile"]["window_s"]
    checks = rec["checks"]
    out = {
        "correct": bool(rec["failed"] == 0 and all(c["ok"] for c in checks.values())),
        "attempted": int(rec["attempted"]),
        "failed": int(rec["failed"]),
        "metrics": metrics,
        "device": dev,
    }
    if trace and "profile" in rec:
        out["breakdown"] = rec["profile"]["breakdown"]
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return out


def check(value: float, limit: float) -> dict:
    """One compared number beside its limit; a number that is not finite
    fails and is written as 1e30."""
    value = float(value)
    if not math.isfinite(value):
        return {"value": 1e30, "limit": float(limit), "ok": False}
    return {"value": value, "limit": float(limit), "ok": bool(value <= limit)}
