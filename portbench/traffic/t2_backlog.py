"""Closed-loop offline serving of a Tacotron 2 configuration: ``backlog``'s
clients (each submits its next request to ``DynamicBatcher`` as soon as its
last one returns, so the batcher always has full batches waiting), with
Tacotron 2's own weights (``reference/tacotron2_weights.py``), bound totals
(``counts_tacotron2.py``) and check (``reference/tacotron2.py``).

Parameters as ``backlog``.  The tap also records each checked request's
row index in its served batch: the prenet's dropout masks, and so the
served frames, depend on it, and the reference draws the same masks.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench import counts_tacotron2, harness, serving
from portbench.reference.model import fp8, ident, no_tf32
from portbench.reference.tacotron2 import PlainT2, prenet_seed
from portbench.reference.tacotron2_weights import make_weights
from portbench.reference.text import sentence_ids


class RowTap(serving.DecodeTap):
    """``DecodeTap`` that also keeps each kept request's row index."""

    def __init__(self, synth, keep: set, model_cfg: dict):
        super().__init__(synth, keep, model_cfg)
        self.rows: dict[str, int] = {}

    def _wrap(self, fn):
        inner = super()._wrap(fn)

        def decode(phoneme, lens):
            out = inner(phoneme, lens)
            for i, text in enumerate(self.texts):
                if text in self.keep:
                    self.rows[text] = i
            return out

        return decode


def decode_totals(m: dict, timed: serving.TimedSynth, tap: RowTap) -> dict:
    """As ``serving.decode_totals``, with Tacotron 2's step bound."""
    span = steps = bound = 0.0
    for (t0, t1, _), b in zip(timed.spans, tap.batches):
        if b["clean"]:
            span += t1 - t0
            steps += b["steps"]
            bound += counts_tacotron2.decode_bound_s(m, b["b"], b["tp"], b["steps"])
    return {"decode_span_s": span, "decode_steps": steps, "decode_bound_s": bound}


def profile_record(tap: RowTap, m: dict) -> dict | None:
    """The profiler's summary and the summed step bound of the profiled
    batches (``t2_bound_s``, read by ``tacotron2_step.roofline``)."""
    if tap.prof is None or tap.prof.prof is None:
        return None
    if tap.prof.running:
        tap.prof.stop()
    prof = tap.prof.summary()
    prof["t2_bound_s"] = sum(counts_tacotron2.decode_bound_s(m, b, tp, n)
                             for b, tp, n in tap.profiled)
    return prof


@torch.no_grad()
def read_served(ctx, weights, served: list[dict], q=ident) -> dict:
    """Widest gaps over the served requests between an output and the plain
    Tacotron 2 in float32 at each position of the served prefix (the frames,
    the gate logits, the caller's mel after the postnet), and the number of
    requests whose phoneme ids differ from the reference's.  ``q`` other
    than the identity reads the control in the program's place."""
    no_tf32()
    m, st = ctx.config["model"], ctx.config["stats"]
    seed = prenet_seed(ctx.config["training"]["seed"])
    rate = float(ctx.config["runtime"].get("infer_prenet_dropout", 0.0))
    out = {"frame_gap": 0.0, "stop_gap": 0.0, "post_gap": 0.0, "ids_mismatch": 0}
    ids = []
    for s in served:
        _, _, same = serving._ids(s, ctx.device)
        out["ids_mismatch"] += 0 if same else 1
        ids.append(torch.as_tensor(sentence_ids(s["text"]), device=ctx.device))
    frames = torch.stack([s["frames"].float() for s in served])
    rows = [s["row"] for s in served]
    mel, gate, post = PlainT2(m, weights).served(ids, frames, rows, seed, rate)
    if q is not ident:
        l_mel, l_gate, l_post = PlainT2(m, weights, q=q).served(ids, frames, rows, seed, rate)
    for i, s in enumerate(served):
        want_mel = (post[i] * (st["std"] + 1e-8) + st["mean"]).t()
        if q is ident:
            got_frames, got_stop = frames[i], s["stops"].float()
            got_mel = torch.as_tensor(np.ascontiguousarray(s["mel"]), device=ctx.device)
        else:
            got_frames, got_stop = l_mel[i], l_gate[i]
            got_mel = (l_post[i] * (st["std"] + 1e-8) + st["mean"]).t()
        out["frame_gap"] = max(out["frame_gap"], serving.gap(got_frames, mel[i]))
        out["stop_gap"] = max(out["stop_gap"], serving.gap(got_stop, gate[i]))
        out["post_gap"] = max(out["post_gap"], serving.gap(got_mel, want_mel))
    return out


def checks(ctx, weights, served: list[dict]) -> tuple[dict, dict | None]:
    limits = ctx.params["limits"]
    got = read_served(ctx, weights, served)
    res = {k: harness.check(got[k], limits[k]) for k in ("frame_gap", "stop_gap", "post_gap")}
    res["ids_mismatch"] = harness.check(got["ids_mismatch"], 0)
    return res, (read_served(ctx, weights, served, q=fp8) if ctx.control else None)


def run(ctx) -> dict:
    from transformertts_tpu_torch.infer.serving import DynamicBatcher

    p, m = ctx.params, ctx.config["model"]
    cfg = serving.program_cfg(ctx)
    weights = make_weights(m, ctx.seed, ctx.device)
    synth = serving.build_synth(ctx, cfg, weights)
    texts, lens = serving.requests(ctx, int(p["pool"]))
    checked = serving.draw_checked(ctx, lens, p["check_among"])
    serving.warm(synth, cfg, p["max_batch"], p["frames"])

    tap = RowTap(synth, {texts[i] for i in checked}, m)
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
    prof = profile_record(tap, m)
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
        **decode_totals(m, timed, tap),
    }
    if prof is not None:
        rec["profile"] = prof
    served = [dict(serving.served_record(texts[i], tap.kept[texts[i]], results[i][1]),
                   row=tap.rows[texts[i]]) for i in checked
              if texts[i] in tap.kept and i in results and results[i][1] is not None]
    unchecked = len([i for i in checked if i in results]) - len(served)
    del synth, timed, tap, batcher, results
    harness.free_device()
    harness.note(ctx, "profile read, check starts")
    rec["checks"], rec["control"] = checks(ctx, weights, served) if served else ({}, None)
    rec["checks"]["unchecked"] = harness.check(unchecked, 0)
    rec["checks"]["too_few_checked"] = harness.check(max(0, 4 - len(served)), 0)
    return rec
