"""Open-loop serving: independent users whose requests arrive as a Poisson
process at a fixed rate, into ``DynamicBatcher.submit`` in the process.

Parameters (the cell's ``params``): ``rate_per_s``; ``phonemes`` (mean,
std, low, high) of the prompt lengths; ``frames`` served per request with
``stop_threshold`` above 1, so every request decodes ``frames`` frames;
``max_batch`` and ``max_wait_ms`` of the batcher; ``shape_seed`` of the
fixed multisets of gaps and lengths; ``n_checked`` requests read by the
check, and its ``limits``.

Every request due in the window is waited for; its latency runs from the
time it was due to the mel in the caller's hand.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness, serving, textgen


def run(ctx) -> dict:
    from transformertts_tpu_torch.infer.serving import DynamicBatcher

    p = ctx.params
    cfg = serving.program_cfg(ctx)
    weights = serving.new_weights(ctx)
    synth = serving.build_synth(ctx, cfg, weights)
    n = max(1, int(round(p["rate_per_s"] * ctx.seconds)))
    gaps = np.random.default_rng(p["shape_seed"]).exponential(1.0, n)
    gaps = textgen.run_rng(ctx.seed, 4).permutation(gaps / gaps.sum() * ctx.seconds)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    texts, lens = serving.requests(ctx, n)
    checked = serving.draw_checked(ctx, lens, n)
    serving.warm(synth, cfg, p["max_batch"], p["frames"])

    tap = serving.DecodeTap(synth, {texts[i] for i in checked}, ctx.config["model"])
    timed = serving.TimedSynth(synth, tap)
    batcher = DynamicBatcher(timed, max_batch=p["max_batch"], max_wait_ms=p["max_wait_ms"],
                             max_len=p["frames"])
    done = [None] * n
    futures = []
    try:
        serving.warm_batcher(batcher, timed, tap)
        s0 = batcher.stats()
        setup_s = time.time() - ctx.t_start
        harness.note(ctx, "window opens")
        t0 = time.perf_counter()
        serving.profile_plan(ctx, tap, t0)
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            fut = batcher.submit(texts[i])
            fut.add_done_callback(lambda f, i=i: done.__setitem__(i, time.perf_counter()))
            futures.append(fut)
        mels, failed = [], 0
        for fut in futures:
            try:
                mels.append(fut.result(timeout=max(1.0, t0 + ctx.seconds + 60 - time.perf_counter())))
            except Exception:  # noqa: BLE001 - a request that fails or never comes counts as failed
                mels.append(None)
                failed += 1
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
        s1 = batcher.stats()
        serving.finish_profile(batcher, tap)
    finally:
        batcher.close()
    harness.note(ctx, "window closed")
    prof = serving.profile_record(tap)
    lat = [((done[i] - t0 - due[i]) * 1e3) if mels[i] is not None and done[i] else float("inf")
           for i in range(n)]
    before = tap.prof_asked or float("inf")  # batches started before the profiler
    starts = {t: s[0] for s in timed.spans for t in s[2] if s[0] < before}
    rec = {
        "setup_s": setup_s,
        "attempted": n,
        "failed": failed,
        "memory_peak_bytes": peak,
        "latency_ms": lat,
        "queue_wait_ms": [(starts[texts[i]] - t0 - due[i]) * 1e3 for i in range(n)
                          if texts[i] in starts],
        "batcher": {k: s1[k] - s0[k] for k in ("n_requests", "n_batches")},
        **serving.decode_totals(ctx, timed, tap),
    }
    if prof is not None:
        rec["profile"] = prof
    served = [serving.served_record(texts[i], tap.kept[texts[i]], mels[i]) for i in checked
              if texts[i] in tap.kept and mels[i] is not None]
    unchecked = len(checked) - len(served)
    del synth, timed, tap, batcher, futures, mels
    harness.free_device()
    harness.note(ctx, "profile read, check starts")
    rec["checks"], rec["control"] = serving.checks(ctx, weights, served)
    rec["checks"]["unchecked"] = harness.check(unchecked, 0)
    rec["checks"]["too_few_checked"] = harness.check(max(0, 4 - len(served)), 0)
    return rec
