"""What the serving cells share: the synthesizer under test, the taps that
see each decode without changing it, the seeded requests, and the check
of served requests against the plain reference.

The taps wrap the synthesizer's decode entry points
(``Synthesizer._decode_fn`` for one-shot batches, the ``init`` of
``Synthesizer._streams[key]`` for streams): each call is timed, its batch
shape and steps are counted, and the buffers it returns (the frames before
the postnet, the stop logits) are kept for the requests drawn for the
check.  Nothing is copied inside the window; the buffers are the ones the
decode allocated for the batch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import counts, harness, textgen
from portbench.reference.model import Plain, fp8, ident, no_tf32
from portbench.reference.text import sentence_ids
from portbench.reference.weights import make_weights


def program_cfg(ctx):
    p = ctx.params
    return harness.program_config(ctx.config, {"infer_max_len": p["frames"],
                                               "stop_threshold": p["stop_threshold"]})


def build_synth(ctx, cfg, weights):
    from transformertts_tpu_torch.infer.api import Synthesizer

    return Synthesizer(cfg, state_dict=weights, stats=dict(ctx.config["stats"]),
                       device=ctx.device)


def requests(ctx, n: int) -> tuple[list[str], np.ndarray]:
    """n distinct sentences whose phoneme lengths are the cell's fixed
    multiset in the order ``--seed`` gives, and those lengths."""
    p = ctx.params
    lens = textgen.clipped_normal(p["shape_seed"], n, *p["phonemes"])
    lens = textgen.run_rng(ctx.seed, 1).permutation(lens)
    return textgen.sentences(textgen.run_rng(ctx.seed, 2), lens), lens


def draw_checked(ctx, lens: np.ndarray, among: int) -> list[int]:
    """Indices of the requests the check reads: ``n_checked`` drawn from
    the seed among the first ``among``, with the longest prompt."""
    among = min(among, len(lens))
    k = min(ctx.params["n_checked"], among)
    pick = set(textgen.run_rng(ctx.seed, 3).choice(among, size=k, replace=False).tolist())
    pick.add(int(np.argmax(lens[:among])))
    return sorted(pick)


class DecodeTap:
    """Wraps ``synth._decode_fn``; one entry per decode call in ``batches``.
    ``texts`` (set by the caller before each call) names the batch's rows.
    In a traced run the profiler starts before the first call at or after
    ``prof_from`` and stops after the first call that ends ``prof_for``
    seconds after it started (perf_counter times), so it holds whole
    batches.  A batch is ``clean`` when no profiler had started before it."""

    def __init__(self, synth, keep: set, model_cfg: dict):
        self.keep, self.m = keep, model_cfg
        self.batches: list[dict] = []
        self.kept: dict[str, tuple] = {}  # text -> (padded ids row, length, frames, stops)
        self.texts: list[str] = []
        self.prof = None
        self.prof_from = self.prof_for = None
        self.prof_asked = None  # when the profiler was asked to start
        self.t_close = float("inf")  # the window's end: the profiler stops by then
        self.force_stop = False
        self.profiled: list[tuple[int, int, int]] = []  # (rows, Tp, steps) of profiled batches
        orig = synth._decode_fn

        def decode_fn(max_len, stop_threshold):
            return self._wrap(orig(max_len, stop_threshold))

        synth._decode_fn = decode_fn

    def _wrap(self, fn):
        def decode(phoneme, lens):
            prof = self.prof
            clean = prof is None or prof.prof is None  # no profiler has run yet
            if clean and prof is not None and time.perf_counter() >= self.prof_from:
                self.prof_asked = time.perf_counter()
                prof.start()  # the first start in a process takes seconds
                clean = False
            profiled = prof is not None and prof.running
            t0 = time.perf_counter()
            out = fn(phoneme, lens)
            t1 = time.perf_counter()
            b, tp = phoneme.shape
            steps = int(out["n_steps"])
            self.batches.append({"t0": t0, "t1": t1, "b": b, "tp": tp, "steps": steps,
                                 "clean": clean})
            if profiled:
                self.profiled.append((b, tp, steps))
                if t1 >= min(prof.t0 + self.prof_for, self.t_close) or self.force_stop:
                    prof.stop()
            for i, text in enumerate(self.texts):
                if text in self.keep:
                    self.kept[text] = (phoneme[i], int(lens[i]), out["pred_melspec"][i],
                                       out["pred_stop"][i])
            return out

        return decode


class TimedSynth:
    """The synthesizer handed to ``DynamicBatcher``: the same calls, with a
    span around each batch (``spans``: start, end, texts)."""

    def __init__(self, synth, tap: DecodeTap):
        self.synth, self.tap = synth, tap
        self.spans: list[tuple[float, float, list[str]]] = []

    def synthesize(self, texts, max_len=None, **kw):
        t0 = time.perf_counter()
        self.tap.texts = list(texts)
        mels = self.synth.synthesize(texts, max_len=max_len, **kw)
        self.spans.append((t0, time.perf_counter(), list(texts)))
        return mels

    def __getattr__(self, name):
        return getattr(self.synth, name)


def warm(synth, cfg, max_batch: int, frames: int) -> None:
    """Load every kernel and plan the shapes the traffic uses: each
    (bucket, batch size) at a short decode, then one full-length batch
    through the served entry."""
    synth.warmup(batch_sizes=tuple(range(1, max_batch + 1)),
                 buckets=tuple(cfg.runtime.phoneme_buckets), max_len=64)
    synth.synthesize(["A warm up sentence of a few words."] * max_batch, max_len=frames)
    torch.cuda.synchronize() if synth.device.type == "cuda" else None


def decode_totals(ctx, timed: TimedSynth, tap: DecodeTap) -> dict:
    """Host seconds of the batches' ``synthesize`` spans, their decode
    steps and the steps' summed bound, over the batches decoded before the
    profiler was started (it slows the host)."""
    span = steps = bound = 0.0
    for (t0, t1, _), b in zip(timed.spans, tap.batches):
        if b["clean"]:
            span += t1 - t0
            steps += b["steps"]
            bound += counts.decode_bound_s(ctx.config["model"], b["b"], b["tp"], 0, b["steps"])
    return {"decode_span_s": span, "decode_steps": steps, "decode_bound_s": bound}


def warm_batcher(batcher, timed: TimedSynth, tap: DecodeTap) -> None:
    """One request through the batcher's thread before the window."""
    batcher.synthesize("A warm up sentence of a few words.", timeout=600)
    timed.spans.clear()
    tap.batches.clear()


def profile_plan(ctx, tap: DecodeTap, t0: float) -> None:
    """In a traced run the profiler holds the whole batches from 0.6 of the
    window on, for ``profile_for`` seconds or until the window closes; what
    spans read comes from before it started.  The profiler is started and
    stopped in the thread that decodes."""
    if ctx.trace and ctx.device.type == "cuda":
        tap.prof = harness.DeviceProfile()
        tap.prof_from, tap.prof_for = t0 + 0.6 * ctx.seconds, profile_for(ctx)
        tap.t_close = t0 + ctx.seconds


def profile_for(ctx) -> float:
    return min(2.0, 0.1 * ctx.seconds)


def finish_profile(batcher, tap: DecodeTap) -> None:
    """Stop a profiler still running after the window in the batcher's
    thread, by one more request there."""
    if tap.prof is not None and tap.prof.running:
        tap.force_stop = True
        batcher.synthesize("A warm up sentence of a few words.", timeout=600)


def profile_record(tap: DecodeTap) -> dict | None:
    if tap.prof is None or tap.prof.prof is None:
        return None
    if tap.prof.running:
        tap.prof.stop()
    prof = tap.prof.summary()
    prof["decode_bound_s"] = sum(counts.decode_bound_s(tap.m, b, tp, 0, n) for b, tp, n in tap.profiled)
    return prof


# ------------------------------------------------------------------ the check


def gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest |a - ref| over max(1, max |ref|)."""
    if a.shape != ref.shape:
        return float("inf")
    return float((a.float() - ref).abs().max() / ref.abs().max().clamp(min=1.0))


def _ids(s: dict, device) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """The reference's padded ids and length of a served request, and
    whether the program's row holds the same."""
    ids = sentence_ids(s["text"])
    want = np.zeros(s["tp"], np.int64)
    want[: len(ids)] = ids
    same = len(ids) == s["length"] and np.array_equal(np.asarray(s["ids"]), want)
    return (torch.as_tensor(want, device=device)[None], torch.tensor([len(ids)], device=device),
            same)


@torch.no_grad()
def read_served(ctx, weights, served: list[dict], q=ident) -> dict:
    """Widest gaps, over the served requests, between an output and the
    plain model in float32 at each position of the served prefix: the
    frames, the stop logits and the caller's mel after the postnet, and the
    number of requests whose phoneme ids differ from the reference's.

    Each of ``served``: text, ids (the program's padded row), tp, length,
    frames (the served frames before the postnet), stops, mel (the
    caller's array).  ``q`` other than the identity reads the control
    instead of the program: the reference with every product's operands
    rounded by ``q``, at each position of the same prompts and frames."""
    no_tf32()
    m, st = ctx.config["model"], ctx.config["stats"]
    ref = Plain(m, weights)
    low = Plain(m, weights, q=q) if q is not ident else None
    out = {"frame_gap": 0.0, "stop_gap": 0.0, "post_gap": 0.0, "ids_mismatch": 0}
    for s in served:
        ids_t, lens_t, same = _ids(s, ctx.device)
        out["ids_mismatch"] += 0 if same else 1
        frames = s["frames"].float()[None]
        mel, stop, post = ref.served(ids_t, lens_t, frames)
        want_mel = (post[0] * (st["std"] + 1e-8) + st["mean"]).t()
        if low is None:
            got_frames, got_stop = frames[0], s["stops"].float()
            got_mel = torch.as_tensor(np.ascontiguousarray(s["mel"]), device=ctx.device)
        else:
            l_mel, l_stop, l_post = low.served(ids_t, lens_t, frames)
            got_frames, got_stop = l_mel[0], l_stop[0]
            got_mel = (l_post[0] * (st["std"] + 1e-8) + st["mean"]).t()
        out["frame_gap"] = max(out["frame_gap"], gap(got_frames, mel[0]))
        out["stop_gap"] = max(out["stop_gap"], gap(got_stop, stop[0]))
        out["post_gap"] = max(out["post_gap"], gap(got_mel, want_mel))
    return out


def checks(ctx, weights, served: list[dict]) -> tuple[dict, dict | None]:
    """The cell's checks (each number beside its limit) and, in a control
    run, the control's readings of the same requests."""
    limits = ctx.params["limits"]
    got = read_served(ctx, weights, served)
    res = {k: harness.check(got[k], limits[k]) for k in ("frame_gap", "stop_gap", "post_gap")}
    res["ids_mismatch"] = harness.check(got["ids_mismatch"], 0)
    return res, (read_served(ctx, weights, served, q=fp8) if ctx.control else None)


def new_weights(ctx):
    return make_weights(ctx.config["model"], ctx.seed, ctx.device)


def served_record(text: str, kept: tuple, mel) -> dict:
    ids, length, frames, stops = kept
    return {"text": text, "ids": ids, "tp": len(ids), "length": length, "frames": frames,
            "stops": stops, "mel": mel}
