"""Closed-loop offline serving: ``clients`` threads, each submitting its
next request to ``DynamicBatcher`` as soon as its last one returns, so the
batcher always has full batches waiting.

Parameters as ``poisson`` (without a rate), plus ``clients`` and
``check_among``: the checked requests are drawn among the first that many.
Requests are drawn from a fixed pool of sentences; none is started after
the window closes, and those in flight then are waited for but add no
frames.
"""

from __future__ import annotations

import threading
import time

import torch

from portbench import harness, serving


def run(ctx) -> dict:
    from transformertts_tpu_torch.infer.serving import DynamicBatcher

    p = ctx.params
    cfg = serving.program_cfg(ctx)
    weights = serving.new_weights(ctx)
    synth = serving.build_synth(ctx, cfg, weights)
    texts, lens = serving.requests(ctx, int(p["pool"]))
    checked = serving.draw_checked(ctx, lens, p["check_among"])
    serving.warm(synth, cfg, p["max_batch"], p["frames"])

    tap = serving.DecodeTap(synth, {texts[i] for i in checked}, ctx.config["model"])
    timed = serving.TimedSynth(synth, tap)
    batcher = DynamicBatcher(timed, max_batch=p["max_batch"], max_wait_ms=p["max_wait_ms"],
                             max_len=p["frames"])
    lock = threading.Lock()
    nxt = [0]
    results: dict[int, tuple] = {}  # index -> (done time, mel or None)

    def client(t_close: float) -> None:
        while time.perf_counter() < t_close:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(texts):
                return
            try:
                mel = batcher.submit(texts[i]).result(timeout=t_close + 60 - time.perf_counter())
            except Exception:  # noqa: BLE001 - a request that fails or never comes
                mel = None
            results[i] = (time.perf_counter(), mel)

    try:
        serving.warm_batcher(batcher, timed, tap)
        s0 = batcher.stats()
        setup_s = time.time() - ctx.t_start
        harness.note(ctx, "window opens")
        t0 = time.perf_counter()
        t_close = t0 + ctx.seconds
        serving.profile_plan(ctx, tap, t0)
        threads = [threading.Thread(target=client, args=(t_close,)) for _ in range(p["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=ctx.seconds + 120)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client thread did not end")
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
        s1 = batcher.stats()
        serving.finish_profile(batcher, tap)
    finally:
        batcher.close()
    if nxt[0] >= len(texts):
        raise harness.HarnessError(f"the pool of {len(texts)} requests ran out in the window", 1)
    harness.note(ctx, "window closed")
    prof = serving.profile_record(tap)
    failed = sum(1 for _, mel in results.values() if mel is None)
    frames = sum(mel.shape[1] for t, mel in results.values() if mel is not None and t <= t_close)
    rec = {
        "setup_s": setup_s,
        "attempted": len(results),
        "failed": failed,
        "memory_peak_bytes": peak,
        "window_s": ctx.seconds,
        "frames_in_window": frames,
        "batcher": {k: s1[k] - s0[k] for k in ("n_requests", "n_batches")},
        **serving.decode_totals(ctx, timed, tap),
    }
    if prof is not None:
        rec["profile"] = prof
    served = [serving.served_record(texts[i], tap.kept[texts[i]], results[i][1]) for i in checked
              if texts[i] in tap.kept and i in results and results[i][1] is not None]
    unchecked = len([i for i in checked if i in results]) - len(served)
    del synth, timed, tap, batcher, results
    harness.free_device()
    harness.note(ctx, "profile read, check starts")
    rec["checks"], rec["control"] = serving.checks(ctx, weights, served)
    rec["checks"]["unchecked"] = harness.check(unchecked, 0)
    rec["checks"]["too_few_checked"] = harness.check(max(0, 4 - len(served)), 0)
    return rec
