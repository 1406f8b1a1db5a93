#!/usr/bin/env python3
"""The Tacotron 2 step kernel on the card, at NVIDIA's widths
(``portbench/configs/tacotron2.json``), against its plain version.

- ``build``: builds ``ops/csrc/tacotron2_step.cu`` and prints ptxas's
  registers and spills of each kernel;
- ``step``: ``--steps`` steps of B 1 and 8 rows over Tp 192 (prenet dropout
  0.5), the kernel and ``tacotron2_step_reference`` each from its own
  state, both fed the kernel's frames: the widest gap of each output and
  state over the steps, relative to max(1, max |reference|);
- ``decode``: the kernel loop against the plain loop (``use_kernel=False``)
  at B 1 and 8, Tp 192, 576 forced frames; the same batch decoded again
  (warm) bit for bit; ``hit`` after ``Synthesizer.warmup``;
- ``time``: device time of a step (CUDA events over 200 steps) at B 1 and
  8, and by kernel from ``torch.profiler``, beside the step's bound.

Prints one JSON line a phase.

    python probes/t2_step_check.py [--phases build,step,decode,time] [--steps 64]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import counts_tacotron2, harness  # noqa: E402
from portbench.reference.tacotron2_weights import make_weights  # noqa: E402


def setup(b: int, tp: int, seed: int = 2**31 + 99):
    from transformertts_tpu_torch.models.tacotron2 import Tacotron2

    conf = harness.config_spec("tacotron2")
    cfg = harness.program_config(conf, {"infer_max_len": 576, "stop_threshold": 2.0})
    dev = torch.device("cuda", 0)
    model = Tacotron2(cfg.model, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(make_weights(conf["model"], seed, dev), strict=True)
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(tp // 2, tp + 1, (b,), generator=gen)
    lens[0] = tp
    ids = torch.randint(1, 90, (b, tp), generator=gen)
    ids = torch.where(torch.arange(tp)[None] < lens[:, None], ids, 0)
    return conf, cfg, model, ids.to(dev), lens.to(dev)


def gap(a, ref):
    return float((a.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1.0))


def phase_build():
    from transformertts_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build(["tacotron2_step"])["tacotron2_step"]
    log = path.with_suffix(".log").read_text()
    lines = [ln.strip() for ln in log.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    print("\n".join(lines[:80]), file=sys.stderr)
    return {"phase": "build", "s": time.perf_counter() - t0,
            "spills": [ln for ln in lines if "spill" in ln and
                       "0 bytes spill stores, 0 bytes spill loads" not in ln]}


@torch.no_grad()
def phase_step(steps: int):
    from transformertts_tpu_torch.ops.tacotron2_step import (
        Tacotron2State, Tacotron2Step, pack_tacotron2_weights, tacotron2_step_reference)

    out = {"phase": "step"}
    for b in (1, 8):
        conf, cfg, model, ids, lens = setup(b, 192)
        memory = model.encode(ids, lens)
        pm = model.process_memory(memory)
        packed = pack_tacotron2_weights(model)
        lens32 = lens.int()
        sk = Tacotron2State(packed, b, 192, ids.device)
        sr = Tacotron2State(packed, b, 192, ids.device)
        step = Tacotron2Step(memory, pm, lens32, packed, sk)
        frame = torch.zeros((b, 80), device=ids.device)
        worst: dict[str, float] = {}
        for t in range(steps):
            yk = step(t, frame, prenet_dropout=0.5, seed=1234 ^ 0x5EED).clone()
            yr = tacotron2_step_reference(t, frame, sr, memory, pm, lens32, packed,
                                          prenet_dropout=0.5, seed=1234 ^ 0x5EED)
            torch.cuda.synchronize()
            for name in ("y", "p", "q", "energy", "alpha", "alpha_cum", "ctx", "c1", "c2"):
                a, r = getattr(sk, name), getattr(sr, name)
                if name == "energy":
                    a, r = torch.nan_to_num(a, neginf=0.0), torch.nan_to_num(r, neginf=0.0)
                worst[name] = max(worst.get(name, 0.0), gap(a, r))
            for name in ("h1", "h2"):
                new = (t + 1) & 1
                worst[name] = max(worst.get(name, 0.0),
                                  gap(getattr(sk, name)[new], getattr(sr, name)[new]))
            if t == 0:
                out[f"b{b}_first"] = {k: round(v, 7) for k, v in worst.items()}
            frame = yk[:, :80].clone(memory_format=torch.contiguous_format)
            # the reference continues from the kernel's frame but its own state
        out[f"b{b}_worst"] = {k: round(v, 7) for k, v in worst.items()}
    return out


@torch.no_grad()
def phase_decode():
    from transformertts_tpu_torch.infer.api import Synthesizer
    from transformertts_tpu_torch.infer.decode import DecodeWeights, make_decode_fn
    from transformertts_tpu_torch.utils import trace

    out = {"phase": "decode"}
    for b in (1, 8):
        conf, cfg, model, ids, lens = setup(b, 192)
        w = DecodeWeights(model)
        kern = make_decode_fn(model, cfg, max_len=576, device=ids.device, weights=w)
        plain = make_decode_fn(model, cfg, max_len=576, use_kernel=False, device=ids.device)
        t0 = time.perf_counter()
        a = kern(ids, lens)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        a2 = kern(ids, lens)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        p = plain(ids, lens)
        out[f"b{b}"] = {
            "steps": [a["n_steps"], p["n_steps"]],
            "frame_gap": gap(a["pred_melspec"], p["pred_melspec"]),
            "stop_gap": gap(a["pred_stop"], p["pred_stop"]),
            "post_gap": gap(a["post_melspec"], p["post_melspec"]),
            "warm_bitequal": all(bool(torch.equal(a[k], a2[k])) for k in
                                 ("pred_melspec", "pred_stop", "post_melspec")),
            "cold_s": t_cold, "warm_s": t_warm, "ms_per_step_warm": 1e3 * t_warm / 576,
        }
    conf = harness.config_spec("tacotron2")
    cfg = harness.program_config(conf, {"infer_max_len": 576, "stop_threshold": 2.0})
    synth = Synthesizer(cfg, state_dict=make_weights(conf["model"], 7, torch.device("cuda", 0)),
                        stats=dict(conf["stats"]), device="cuda")
    synth.warmup(batch_sizes=(1, 8), buckets=(64, 192), max_len=16)
    mark = len(trace.spans())
    synth.synthesize(["A sentence of a few words for the check."] * 8, max_len=576)
    plans = [s for s in trace.spans()[mark:] if s.name == "decode.plan"]
    chunks = list(synth.stream("A sentence of a few words for the check.", chunk=64, max_len=576))
    one = synth.synthesize("A sentence of a few words for the check.", max_len=576)[0]
    import numpy as np

    streamed = np.concatenate(chunks, axis=1)
    out["hit_after_warmup"] = [bool(s.attrs.get("hit")) for s in plans]
    out["stream_vs_oneshot"] = float(np.abs(streamed - one).max()) if streamed.shape == one.shape \
        else f"shapes {streamed.shape} {one.shape}"
    out["names"] = sorted({s.name for s in trace.spans()[mark:]})
    return out


@torch.no_grad()
def phase_time():
    from torch.profiler import ProfilerActivity, profile

    from transformertts_tpu_torch.ops.tacotron2_step import (
        Tacotron2State, Tacotron2Step, pack_tacotron2_weights)

    out = {"phase": "time"}
    for b in (1, 8):
        conf, cfg, model, ids, lens = setup(b, 192)
        memory = model.encode(ids, lens)
        pm = model.process_memory(memory)
        packed = pack_tacotron2_weights(model)
        st = Tacotron2State(packed, b, 192, ids.device)
        step = Tacotron2Step(memory, pm, lens.int(), packed, st)
        frame = torch.zeros((b, 80), device=ids.device)
        for t in range(20):
            step(t, frame, prenet_dropout=0.5, seed=7)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for t in range(200):
            step(t, frame, prenet_dropout=0.5, seed=7)
        e1.record()
        torch.cuda.synchronize()
        us = 1e3 * e0.elapsed_time(e1) / 200
        host = []  # host time of a call, in bursts of 8 that cannot fill the launch queue
        for burst in range(25):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(8):
                step(t, frame, prenet_dropout=0.5, seed=7)
            host.append((time.perf_counter() - t0) / 8)
        host_us = 1e6 * sorted(host)[len(host) // 2]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for t in range(50):
                step(t, frame, prenet_dropout=0.5, seed=7)
            torch.cuda.synchronize()
        by = {e.key[:60]: round(e.device_time_total / 50, 2) for e in prof.key_averages()
              if e.device_time_total > 0}
        bound = counts_tacotron2.step_bound_s(conf["model"], b, 192) * 1e6
        out[f"b{b}"] = {"step_us": us, "host_us_per_call": host_us, "bound_us": bound,
                        "roofline_pct": 100 * bound / us, "by_kernel_us": by}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="build,step,decode,time")
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    for ph in args.phases.split(","):
        res = {"build": phase_build, "step": lambda: phase_step(args.steps),
               "decode": phase_decode, "time": phase_time}[ph]()
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
