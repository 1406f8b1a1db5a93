"""Closed-loop streaming: one listener at a time through
``Synthesizer.stream(text, chunk)``, as ``cli serve`` streams; the next
request starts when the last chunk of the previous one is in hand, and none
starts after the window closes.

Parameters: ``phonemes``, ``frames``, ``stop_threshold``, ``shape_seed``,
``n_checked``, ``limits`` as ``poisson``; ``chunk`` frames a chunk;
``pool`` sentences to draw from; ``check_among`` as ``backlog``.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench import counts, harness, serving


class StreamTap:
    """Wraps the stream's ``init`` (``Synthesizer._streams[key][0]``): keeps
    the decode state's frame and stop buffers of checked requests."""

    def __init__(self, synth, key, keep: set):
        self.keep, self.text, self.kept = keep, None, {}
        init, chunk_fn, post_fn = synth._streams[key]

        def tapped(phoneme, lens):
            state = init(phoneme, lens)
            if self.text in self.keep:
                self.kept[self.text] = (phoneme[0], int(lens[0]), state.frames[0, 1:],
                                        state.stops[0])
            return state

        synth._streams[key] = (tapped, chunk_fn, post_fn)


def run(ctx) -> dict:
    p = ctx.params
    cfg = serving.program_cfg(ctx)
    weights = serving.new_weights(ctx)
    synth = serving.build_synth(ctx, cfg, weights)
    texts, lens = serving.requests(ctx, int(p["pool"]))
    checked = serving.draw_checked(ctx, lens, p["check_among"])
    chunk, frames = p["chunk"], p["frames"]
    for bucket in cfg.runtime.phoneme_buckets:  # every bucket the prompts use
        n = int(np.clip(bucket - 8, p["phonemes"][2], p["phonemes"][3]))
        list(synth.stream(serving.textgen.sentence(np.random.default_rng(bucket), n),
                          chunk=chunk, max_len=frames))
    tap = StreamTap(synth, (frames, chunk), {texts[i] for i in checked})
    m = ctx.config["model"]
    reqs = []  # per request: start, chunk times, steps before each chunk, mel, profiled
    prof = harness.DeviceProfile() if ctx.trace and ctx.device.type == "cuda" else None
    setup_s = time.time() - ctx.t_start
    harness.note(ctx, "window opens")
    t0 = time.perf_counter()
    t_close = t0 + ctx.seconds
    prof_from = t0 + 0.6 * ctx.seconds  # as the batcher cells: spans read before it
    failed = 0
    while time.perf_counter() < t_close and len(reqs) < len(texts):
        i = len(reqs)
        clean = prof is None or prof.prof is None
        if clean and prof is not None and time.perf_counter() >= prof_from:
            prof.start()  # the first start in a process takes seconds
            clean = False
        profiled = prof is not None and prof.running
        tap.text = texts[i]
        r = {"i": i, "t": time.perf_counter(), "times": [], "steps": [], "clean": clean,
             "profiled": profiled}
        s_prev = synth.steps_decoded
        try:
            parts = []
            for part in synth.stream(texts[i], chunk=chunk, max_len=frames):
                r["times"].append(time.perf_counter())
                r["steps"].append(synth.steps_decoded - s_prev)
                s_prev = synth.steps_decoded
                parts.append(part)
            r["mel"] = np.concatenate(parts, axis=1)
        except Exception:  # noqa: BLE001 - a request that fails counts as failed
            failed += 1
            r["mel"] = None
        reqs.append(r)
        if profiled:
            if time.perf_counter() >= min(prof.t0 + serving.profile_for(ctx), t_close):
                prof.stop()
    harness.note(ctx, "window closed")
    if len(reqs) >= len(texts):
        raise harness.HarnessError(f"the pool of {len(texts)} requests ran out in the window", 1)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    first, setup, span, steps, bound = [], [], 0.0, 0, 0.0
    for r in reqs:
        if r["mel"] is None or not r["times"]:
            continue
        first.append((r["times"][0] - r["t"]) * 1e3)
        later = [(r["times"][k] - r["times"][k - 1], r["steps"][k])
                 for k in range(1, len(r["times"]))]
        if not r["clean"]:
            continue
        per_step = [dt / s for dt, s in later if s > 0]
        if per_step:
            setup.append(first[-1] - r["steps"][0] * statistics.median(per_step) * 1e3)
        bucket = next(b for b in cfg.runtime.phoneme_buckets if b >= lens[r["i"]])
        span += sum(dt for dt, _ in later)
        n_later = sum(s for _, s in later)
        steps += n_later
        bound += counts.decode_bound_s(m, 1, bucket, r["steps"][0], r["steps"][0] + n_later)
    rec = {
        "setup_s": setup_s,
        "attempted": len(reqs),
        "failed": failed,
        "memory_peak_bytes": peak,
        "first_chunk_ms": first,
        "stream_setup_ms": setup,
        "decode_span_s": span,
        "decode_steps": steps,
        "decode_bound_s": bound,
    }
    if prof is not None and prof.prof is not None:
        if prof.running:
            prof.stop()
        rec["profile"] = prof.summary()
        rec["profile"]["decode_bound_s"] = sum(
            counts.decode_bound_s(m, 1, next(b for b in cfg.runtime.phoneme_buckets
                                             if b >= lens[r["i"]]), 0, sum(r["steps"]))
            for r in reqs if r["profiled"])
    served = [serving.served_record(texts[r["i"]], tap.kept[texts[r["i"]]], r["mel"])
              for r in reqs if r["i"] in checked and texts[r["i"]] in tap.kept
              and r["mel"] is not None]
    unchecked = len([i for i in checked if i < len(reqs)]) - len(served)
    del synth, tap, reqs
    harness.free_device()
    harness.note(ctx, "profile read, check starts")
    rec["checks"], rec["control"] = serving.checks(ctx, weights, served)
    rec["checks"]["unchecked"] = harness.check(unchecked, 0)
    rec["checks"]["too_few_checked"] = harness.check(max(0, 4 - len(served)), 0)
    return rec
