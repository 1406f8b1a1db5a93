#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build: the CUDA kernels of ``transformertts_tpu_torch/ops/csrc`` with
   nvcc, one process per source, all at once;
2. kernel: the decode-step kernel against its plain PyTorch version
   (``decode_step_reference``) at the full width of ``Config()`` (d_model
   256, 3 layers, 4 heads, d_ffn 1024, 80 mels): B in {1, 8}, t in
   {0, 1, 700} with 1,500 cache positions and 192 encoder positions, the
   expected-position output off and on, bf16 and fp32 — plus the serving
   shape (400 positions, 64 encoder positions);
3. decode: the full decode through the kernel loop against the plain loop,
   fp32 weights, B = 2 with ragged lengths, 64 forced frames, W = 0 and 2;
4. serve: the main path — ``make_http_server`` -> ``DynamicBatcher`` ->
   ``Synthesizer`` -> kernel loop, with seeded random weights in bf16:
   13 HTTP requests (12 concurrent, then one alone), one batch at the
   default stop threshold and one batch of 12 rows (decoded as kernel
   calls of 8 and 4 rows); the kernel's launch counts are zeroed before
   and read after, and must equal the decode steps run;
5. time: kernel and plain version per step, and decode frames/s through
   ``Synthesizer.synthesize``, with the card's name and power limit.

The last lines are the kernels' JSON record, the card's name and power
limit as nvidia-smi gives them, and ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits with status 1 and prints no result.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16, published
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max|kernel - plain| / max(1, max|plain|)
# kernel loop vs plain loop, fp32, 64 fed-back frames: as the CPU test of the
# port against the JAX loop; the H100 showed at most 1.2e-6 relative
DECODE_TOL = 1e-4
SERVE_MAX_LEN = 400
TEXTS = [
    "Printing, in the only sense with which we are at present concerned.",
    "The quick brown fox jumps over the lazy dog.",
    "He read the letter twice before he answered it.",
    "It is 1984, and the clocks are striking thirteen.",
    "Please call Stella and ask her to bring these things with her.",
    "A journey of a thousand miles begins with a single step.",
    "The rain in Spain stays mainly in the plain.",
    "She sells sea shells by the sea shore.",
    "Mr. Smith paid $42 for the book on Tuesday.",
    "How much wood would a woodchuck chuck?",
    "Time flies like an arrow; fruit flies like a banana.",
    "We shall fight on the beaches, we shall fight on the landing grounds.",
    "Hello world.",
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def perturb_(model, gen) -> None:
    """Random biases and norm parameters, so no bias or LayerNorm offset is
    invisible behind a zero or a one (init leaves them so)."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif ".norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))


def make_model(cfg, dtype, device, seed):
    import torch

    from transformertts_tpu_torch.models import TransformerTTS

    gen = torch.Generator().manual_seed(seed)
    model = TransformerTTS(cfg.model, dtype=dtype, device="cpu", generator=gen)
    perturb_(model, gen)
    return model.to(device)


def rel_err(a, b) -> tuple[float, float]:
    """(max abs err, max abs err / max(1, max|b|))."""
    err = float((a.float() - b.float()).abs().max())
    return err, err / max(1.0, float(b.float().abs().max()))


def step_inputs(cfg, b, t, n_pos, tp, dtype, device, seed):
    """Seeded frame, alpha*PE[t], ragged cross bias and caches for one step."""
    import torch

    from transformertts_tpu_torch.models.masks import NEG_INF
    from transformertts_tpu_torch.models.modules import sinusoid_table

    m = cfg.model
    L, H, dh = m.decoder_n_layers, m.decoder_n_head, m.d_model // m.decoder_n_head
    rng = np.random.default_rng(seed)
    frame = torch.from_numpy(rng.standard_normal((b, m.n_mels), np.float32))
    pe_row = torch.from_numpy(sinusoid_table(t + 1, m.d_model)[t:t + 1])
    lens = rng.integers(tp // 2, tp + 1, b)
    lens[0] = tp
    bias = torch.from_numpy(
        np.where(np.arange(tp)[None, :] < lens[:, None], 0.0, NEG_INF).astype(np.float32))
    caches = [torch.from_numpy(rng.standard_normal((L, H, b, n, dh), np.float32)).to(dtype)
              for n in (n_pos, n_pos, tp, tp)]
    return [x.to(device) for x in (frame, pe_row, bias)], [c.to(device) for c in caches]


def step_bytes_flops(packed, b, t, tp, cfg):
    """Least bytes a step must move (each input read once, each output
    written once) and the operations it must do, for these shapes."""
    m = cfg.model
    L, H, dh = m.decoder_n_layers, m.decoder_n_head, m.d_model // m.decoder_n_head
    es = packed["pw1"].element_size()  # caches are in the weights' dtype
    n_w = sum(p.numel() for p in packed.values())
    w_bytes = sum(p.numel() * p.element_size() for p in packed.values())
    cache = 2 * L * H * b * (t + tp) * dh * es  # self prefix + cross, K and V
    d_out = packed["head_w"].shape[0]
    io_bytes = 4 * b * (m.n_mels + tp + d_out + 1) + 4 * m.d_model + 2 * L * H * b * dh * es
    flops = 2 * b * n_w + 4 * b * L * H * dh * (t + 1 + tp)
    return w_bytes + cache + io_bytes, flops


def time_ms(fn, n: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time per call: ``n`` calls captured in one CUDA graph and the
    graph replayed ``reps`` times between two events, so the host's launch
    cost is outside the window."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the allocator off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    return time_ms(graph.replay, reps, warmup=1) / n


# ------------------------------------------------------------------ phases

def phase_build() -> None:
    from transformertts_tpu_torch import _build

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(str(p.name) for p in libs.values()))
    for path in libs.values():
        text = path.with_suffix(".log").read_text()
        regs = [int(w.split()[0]) for w in text.split("Used ")[1:]]
        spills = [ln.strip() for ln in text.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        log(f"[build] {path.name}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers/thread, spill lines: {spills[:3] or 'none'}")


def phase_kernel(cfg, device) -> dict:
    """Kernel vs plain version; returns the max errors by batch."""
    import torch

    from transformertts_tpu_torch.ops.decode_step import (
        decode_step,
        decode_step_reference,
        pack_decode_weights,
    )

    worst: dict[int, float] = {}
    cases = [(n_pos, tp, t) for n_pos, tp in ((1500, 192),) for t in (0, 1, 700)]
    cases.append((SERVE_MAX_LEN, 64, 200))  # the serving shape
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        model = make_model(cfg, dtype, device, seed=1)
        packed = pack_decode_weights(model, dtype)
        alpha = float(model.pe.alpha.detach())
        for b in (1, 8):
            for n_pos, tp, t in cases:
                for with_pos in (False, True):
                    (frame, pe_row, bias), caches = step_inputs(
                        cfg, b, t, n_pos, tp, dtype, device, seed=b * 1000 + t)
                    pe_row = alpha * pe_row
                    work = [c.clone() for c in caches]
                    out = decode_step(t, frame, pe_row, bias, *work, packed, with_attn_pos=with_pos)
                    torch.cuda.synchronize()
                    ref = decode_step_reference(t, frame, pe_row, bias, *caches, packed, with_pos)
                    errs = []
                    for name, o, r in zip(("y", "k_new", "v_new", "pos"), out, ref):
                        err, rel = rel_err(o, r)
                        errs.append(f"{name} {err:.2e}")
                        worst[b] = max(worst.get(b, 0.0), err)
                        if not rel <= TOL[dtype_name]:
                            raise AssertionError(
                                f"kernel != plain: {dtype_name} B={b} t={t} n_pos={n_pos} "
                                f"tp={tp} pos={with_pos} {name}: rel err {rel:.3g}")
                    for c, new, orig in ((work[0], out[1], caches[0]), (work[1], out[2], caches[1])):
                        if not torch.equal(c[:, :, :, t], new):
                            raise AssertionError("kernel did not write the new row at t")
                        keep = torch.arange(n_pos, device=device) != t
                        if not torch.equal(c[:, :, :, keep], orig[:, :, :, keep]):
                            raise AssertionError("kernel changed cache rows other than t")
                    if not all(torch.isfinite(o).all() for o in out):
                        raise AssertionError("kernel output not finite")
                    log(f"[kernel] {dtype_name:8s} B={b} t={t:4d} n_pos={n_pos} tp={tp} "
                        f"pos={int(with_pos)}: " + ", ".join(errs))
    return worst


def phase_decode(cfg, device) -> None:
    import dataclasses

    import torch

    from transformertts_tpu_torch.infer.decode import make_decode_fn

    model = make_model(cfg, torch.float32, device, seed=2)
    rng = np.random.default_rng(3)
    phoneme = rng.integers(1, 70, (2, 96))
    lens = np.array([96, 61])
    for window in (0, 2):
        c = cfg.replace(runtime=dataclasses.replace(cfg.runtime, decode_attn_window=window))
        outs = [
            make_decode_fn(model, c, max_len=64, stop_threshold=2.0, use_kernel=k,
                           device=device)(phoneme, lens)
            for k in (True, False)
        ]
        kern, plain = outs
        if not kern["n_frames"] == plain["n_frames"] == 64 or not torch.equal(
                kern["n_frames_per_row"], plain["n_frames_per_row"]):
            raise AssertionError(f"W={window}: frame counts differ")
        msg = []
        for k in ("pred_melspec", "pred_stop", "post_melspec"):
            err, rel = rel_err(kern[k], plain[k])
            msg.append(f"{k} {err:.2e} (rel {rel:.1e})")
            if not rel <= DECODE_TOL:
                raise AssertionError(f"W={window}: kernel loop != plain loop on {k}: {rel:.3g}")
        log(f"[decode] fp32 B=2 64 frames W={window}: " + ", ".join(msg))


def _post(url: str, body: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_serve(cfg, device, synth, default_threshold: float) -> dict:
    """The main path; returns the kernel's launch counts of this run."""
    from transformertts_tpu_torch.infer import DynamicBatcher, make_http_server
    from transformertts_tpu_torch.ops.decode_step import decode_step

    batcher = DynamicBatcher(synth, max_batch=8, max_wait_ms=50.0, max_len=SERVE_MAX_LEN)
    server = make_http_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        decode_step.launches = decode_step.launches_batched = 0
        synth.steps_decoded = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(12) as pool:
            replies = list(pool.map(lambda txt: _post(url + "/synthesize", {"text": txt}),
                                    TEXTS[:12]))
        replies.append(_post(url + "/synthesize", {"text": TEXTS[12]}))
        elapsed = time.perf_counter() - t0
        for code, body in replies:
            if code != 200:
                raise AssertionError(f"/synthesize answered {code}: {body[:200]!r}")
            mel = np.load(io.BytesIO(body))
            if mel.shape != (cfg.model.n_mels, SERVE_MAX_LEN) or not np.isfinite(mel).all():
                raise AssertionError(f"bad mel from /synthesize: {mel.shape}")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        hist = {int(k): v for k, v in health["batch_hist"].items()}
        if health["n_requests"] != 13 or max(hist) <= 1:
            raise AssertionError(f"batching did not happen: {health}")
        # one batch at the default stop threshold: the stop path
        mels = synth.synthesize(TEXTS[:4], max_len=SERVE_MAX_LEN,
                                stop_threshold=default_threshold)
        if any(m.shape[0] != cfg.model.n_mels or not 1 <= m.shape[1] <= SERVE_MAX_LEN
               or not np.isfinite(m).all() for m in mels):
            raise AssertionError("bad mel at the default stop threshold")
        # a batch larger than the kernel takes: chunks of 8 and 4 rows
        steps_before = synth.steps_decoded
        wide = synth.synthesize(TEXTS[:12], max_len=SERVE_MAX_LEN)
        if (synth.steps_decoded - steps_before != 2 * SERVE_MAX_LEN
                or any(m.shape != (cfg.model.n_mels, SERVE_MAX_LEN)
                       or not np.isfinite(m).all() for m in wide)):
            raise AssertionError("a 12-row batch was not decoded as two full chunks")
        launches, batched = decode_step.launches, decode_step.launches_batched
        steps = synth.steps_decoded
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    log(f"[serve] 13 HTTP requests in {elapsed:.2f} s, batches {hist}, "
        f"default-threshold batch lengths {[m.shape[1] for m in mels]}, "
        f"12-row batch in chunks of 8 and 4")
    log(f"[serve] kernel launches {launches} (B>1: {batched}) for {steps} decode steps")
    if launches != steps or batched == 0 or launches - batched == 0:
        raise AssertionError("serving did not go through the kernel at B=1 and B>1")
    return {"b1": launches - batched, "batched": batched}


def phase_time(cfg, device, synth, card: str) -> dict:
    import torch

    from transformertts_tpu_torch.ops.decode_step import (
        decode_step,
        decode_step_reference,
        pack_decode_weights,
    )

    model = make_model(cfg, torch.bfloat16, device, seed=1)
    packed = pack_decode_weights(model, torch.bfloat16)
    rows = {}
    shapes = [(1500, 192, 0), (1500, 192, 700), (SERVE_MAX_LEN, 64, 200)]
    for b in (1, 8):
        for n_pos, tp, t in shapes:
            (frame, pe_row, bias), caches = step_inputs(
                cfg, b, t, n_pos, tp, torch.bfloat16, device, seed=7)
            kern = lambda: decode_step(t, frame, pe_row, bias, *caches, packed)  # noqa: E731
            plain = lambda: decode_step_reference(  # noqa: E731
                t, frame, pe_row, bias, *caches, packed)
            call = time_ms(kern, 200, 10)  # back-to-back calls: host launch cost included
            ms, plain_ms = device_ms(kern), device_ms(plain, n=5, reps=4)
            nbytes, flops = step_bytes_flops(packed, b, t, tp, cfg)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_BF16_FLOPS else "operations"
            rows[(b, n_pos, tp, t)] = (ms, plain_ms, bound, by)
            log(f"[time] bf16 B={b} n_pos={n_pos} tp={tp} t={t}: kernel {ms * 1e3:.1f} us/step "
                f"on the device ({call * 1e3:.1f} us per eager call), plain "
                f"{plain_ms * 1e3:.1f} us/step, bound {bound * 1e3:.2f} us ({by}, "
                f"{nbytes / 1e6:.2f} MB) [{card}]")
    for b in (1, 8):
        synth.synthesize(TEXTS[:b], max_len=32)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synth.synthesize(TEXTS[:b], max_len=SERVE_MAX_LEN)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[time] Synthesizer.synthesize B={b}, {SERVE_MAX_LEN} frames/row: {dt:.3f} s, "
            f"{b * SERVE_MAX_LEN / dt:.0f} frames/s, {dt / SERVE_MAX_LEN * 1e3:.3f} ms/step [{card}]")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="build,kernel,decode,serve,time",
                    help="comma-separated subset, for development runs")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 1
    import dataclasses

    from transformertts_tpu_torch.config import Config
    from transformertts_tpu_torch.infer import Synthesizer

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain side runs true fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    cfg = Config()
    t_start = time.perf_counter()
    if "build" in phases:
        phase_build()
    worst = phase_kernel(cfg, device) if "kernel" in phases else {}
    if "decode" in phases:
        phase_decode(cfg, device)
    launches, rows = {}, {}
    if phases & {"serve", "time"}:
        scfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime, stop_threshold=2.0))
        gen_model = make_model(scfg, torch.bfloat16, "cpu", seed=5)
        synth = Synthesizer(scfg, state_dict=gen_model.state_dict(),
                            stats={"mean": -5.0, "std": 2.0}, device=device)
        if "serve" in phases:
            launches = phase_serve(scfg, device, synth, cfg.runtime.stop_threshold)
        if "time" in phases:
            rows = phase_time(scfg, device, synth, card)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    if phases != {"build", "kernel", "decode", "serve", "time"}:
        log(f"[partial] phases {sorted(phases)} passed; no result for a partial run")
        return 0
    src = "transformertts_tpu_torch/ops/csrc/decode_step.cu"
    kernels = []
    for b, name, line, key in ((1, "decode_step", 300, "b1"),
                               (8, "decode_step_batched", 532, "batched")):
        ms, plain, bound, by = rows[(b, SERVE_MAX_LEN, 64, 200)]
        kernels.append({
            "name": f"{name} (B={b}, bf16, n_pos {SERVE_MAX_LEN}, Tp 64, t 200)",
            "route": "cuda", "source": src,
            "replaces": f"transformertts_tpu/ops/pallas/decode_step.py:{line}",
            "launches": launches[key], "max_abs_err": worst[b],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
