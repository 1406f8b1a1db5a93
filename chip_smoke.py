#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--phases build,kernel,...] [--profile]

Phases, each of which fails the run (non-zero exit) when it fails:

1. build: the CUDA kernels of ``transformertts_tpu_torch/ops/csrc`` with
   nvcc, one process per source, all at once;
2. mask: the device ``keep_mask`` against its plain version, bit for bit;
3. kernel: every kernel against its plain PyTorch version on the card.
   The decode-step kernel (``decode_step_reference``) at the full width of
   ``Config()`` (d_model 256, 3 layers, 4 heads, d_ffn 1024, 80 mels): B in
   {1, 8}, t in {0, 1, 700} with 1,500 cache positions and 192 encoder
   positions, the expected-position output off and on, bf16 and fp32, plus
   the serving shape (400 positions, 64 encoder positions).  The flash
   attention and residual+dropout+LayerNorm kernels, forward and every
   gradient, at the training path's shapes (B 16, 4 heads of 64; (128, 128),
   causal (768, 768), (768, 128); 12,288 and 2,048 rows of 256) and at odd
   ones, fp32 and bf16, dropout 0 and 0.1, ragged key bias; each backward
   twice, for equal bits;
4. decode: the full decode through the kernel loop against the plain loop,
   fp32 weights, B = 2 with ragged lengths, 64 forced frames, W = 0 and 2;
5. serve: the serving path, ``make_http_server`` -> ``DynamicBatcher`` ->
   ``Synthesizer`` -> kernel loop, with seeded random weights in bf16:
   13 HTTP requests (12 concurrent, then one alone), one batch at the
   default stop threshold and one batch of 12 rows (decoded as kernel
   calls of 8 and 4 rows); the kernel's launch counts are zeroed before
   and read after, and must equal the decode steps run;
6. train-parity: one micro-batch of 16 rows at full width in fp32, dropout
   and scheduled sampling on, once through the kernels and once through
   their plain versions from the same generator seeds (so both drop the
   same elements): the loss and every parameter's gradient are compared;
7. train: the training path, ``create_train_state`` + ``make_train_step``
   at ``Config()`` (bf16, 4 micro-batches of 16 rows, 768 mel frames, 128
   phonemes, double forward, dropout on) for 3 optimizer steps on seeded
   synthetic batches, then one ``make_eval_step``; the kernels' launch
   counts are zeroed before and read after, and must be what the path
   implies (per step 72 / 36 flash and 120 / 60 LayerNorm forwards /
   backwards);
8. time: every kernel beside its plain version, its bound and (where one
   PyTorch call computes the same function) that call, decode frames/s
   through ``Synthesizer.synthesize`` and the training step's ms and
   audio-seconds per second, with the card's name and power limit.

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
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores, published
ALL_PHASES = ("build", "mask", "kernel", "decode", "serve", "train-parity", "train", "time")
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


def device_ms(fn, n: int = 20, reps: int = 10, setup=None) -> float:
    """Device time per call: ``n`` calls captured in one CUDA graph and the
    graph replayed ``reps`` times between two events, so the host's launch
    cost is outside the window.  ``setup``, when given, runs once on the
    capture stream and its result is passed to ``fn``: an autograd graph has
    to be built on the stream that its backward is captured on."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the allocator off the capture
        if setup is not None:
            state = setup()
            call = lambda: fn(state)  # noqa: E731
        else:
            call = fn
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            call()
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


# rows 3-6 against their plain versions: max|kernel - plain| / max(1, max|plain|).
# fp32: the same arithmetic in another summation order (and expf against
# torch.exp); gradients sum more terms (dgamma over all rows, dK over all
# queries).  bf16: both round the same quantities once to bf16, a different
# summation order moves single values by one bf16 ulp (2^-8 relative) and the
# flash forward rounds e against its running maximum.
TRAIN_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (forward, gradients)
ATTN_SHAPES = {  # name -> (Tq, Tk, causal): the training path's three attention calls
    "enc_self": (128, 128, False), "dec_self": (768, 768, True), "cross": (768, 128, False)}
LN_ROWS = {"decoder": 16 * 768, "encoder": 16 * 128}
TRAIN_B, TRAIN_H, TRAIN_DH, TRAIN_D = 16, 4, 64, 256


def attn_inputs(b, h, tq, tk, dh, dtype, device, seed):
    """Seeded q, k, v as one fused (B, T, 3 H dh) projection would leave them
    (strided views when Tq == Tk), dO, and a ragged key bias."""
    import torch

    from transformertts_tpu_torch.models.masks import NEG_INF

    rng = np.random.default_rng(seed)
    if tq == tk:
        qkv = torch.from_numpy(rng.standard_normal((b, tq, 3 * h * dh), np.float32))
        q, k, v = (t.reshape(b, tq, h, dh) for t in qkv.to(device, dtype).split(h * dh, dim=-1))
    else:
        q = torch.from_numpy(rng.standard_normal((b, tq, h, dh), np.float32)).to(device, dtype)
        kv = torch.from_numpy(rng.standard_normal((b, tk, 2 * h * dh), np.float32))
        k, v = (t.reshape(b, tk, h, dh) for t in kv.to(device, dtype).split(h * dh, dim=-1))
    dout = torch.from_numpy(rng.standard_normal((b, tq, h, dh), np.float32)).to(device, dtype)
    lens = rng.integers(max(tk // 2, 1), tk + 1, b)
    lens[0] = tk
    bias = torch.from_numpy(
        np.where(np.arange(tk)[None, :] < lens[:, None], 0.0, NEG_INF).astype(np.float32))
    return q, k, v, dout, bias.to(device)


def ln_inputs(n, d, dtype, device, seed):
    import torch

    rng = np.random.default_rng(seed)
    x, h, dy = (torch.from_numpy(rng.standard_normal((n, d), np.float32) * s).to(device, dtype)
                for s in (1.0, 0.5, 1.0))
    gamma = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(device)
    beta = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32)).to(device)
    return x, h, gamma, beta, dy


def run_with_grads(fn, inputs, dout):
    """fn(*inputs) and the gradients of its inputs for the cotangent dout."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    return [out.detach(), *grads]


def check_pair(tag, names, kern, plain, dtype_name, worst, key) -> None:
    """Hold every kernel result against its plain twin; track the worst
    absolute error of the forward (names[0]) and of the gradients."""
    import torch

    msgs = []
    for i, (name, a, b) in enumerate(zip(names, kern, plain)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{tag}: {name} not finite")
        err, rel = rel_err(a, b)
        msgs.append(f"{name} {err:.2e}")
        slot = (key, "fwd" if i == 0 else "bwd")
        worst[slot] = max(worst.get(slot, 0.0), err)
        if not rel <= TRAIN_TOL[dtype_name][min(i, 1)]:
            raise AssertionError(f"kernel != plain: {tag} {name}: rel err {rel:.3g}")
    log(f"[kernel] {tag}: " + ", ".join(msgs))


def phase_mask(device) -> None:
    """The device keep_mask against its plain twin, bit for bit."""
    import torch

    from transformertts_tpu_torch.ops.dropout_mask import keep_mask, keep_mask_reference

    n = 0
    for shape in ((768, 768), (768, 128), (512, 256)):
        for p in (0.1, 0.5):
            for seed in (0, 1234567, 2**31 - 2):
                for salt in (0, 5, 63 * 8192 + 11):
                    dev = keep_mask(shape, p, seed, salt, device=device)
                    ref = keep_mask_reference(shape, p, seed, salt, device=device)
                    if not torch.equal(dev, ref):
                        raise AssertionError(
                            f"device keep_mask != plain at {shape} p={p} seed={seed} salt={salt}: "
                            f"{int((dev != ref).sum())} bits differ")
                    n += 1
    log(f"[mask] device keep_mask bit-equal to the plain version in {n} cases "
        f"(3 shapes x p 0.1, 0.5 x 3 seeds x 3 salts)")


def phase_train_kernels(device) -> dict:
    """Rows 3-6 against their plain versions; returns the worst abs errors."""
    import torch

    from transformertts_tpu_torch.ops.flash_attention import flash_attention
    from transformertts_tpu_torch.ops.fused_ln import residual_dropout_layernorm

    worst: dict = {}
    attn_cases = [(name, TRAIN_B, TRAIN_H, *shape, TRAIN_DH) for name, shape in ATTN_SHAPES.items()]
    attn_cases += [("enc_self_causal", TRAIN_B, TRAIN_H, 128, 128, True, TRAIN_DH),
                   ("dec_self_full", TRAIN_B, TRAIN_H, 768, 768, False, TRAIN_DH),
                   ("odd", 2, 2, 5, 37, False, TRAIN_DH),
                   ("odd_causal", 2, 2, 37, 37, True, TRAIN_DH),
                   ("odd_dh32", 2, 3, 70, 100, False, 32)]  # the other head dim the kernel takes
    ln_cases = [(name, n, TRAIN_D) for name, n in LN_ROWS.items()]
    # ragged row counts, and one width for each register layout of the kernel
    ln_cases += [("odd", 1000, TRAIN_D), ("narrow", 100, 64), ("wide", 520, 512),
                 ("widest", 264, 1024)]
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, b, h, tq, tk, causal, dh in attn_cases:
            for p in (0.0, 0.1):
                q, k, v, dout, bias = attn_inputs(b, h, tq, tk, dh, dtype, device, seed=tq + tk)
                outs = []
                for plain in (False, True, False):
                    outs.append(run_with_grads(
                        lambda q_, k_, v_: flash_attention(
                            q_, k_, v_, bias, causal=causal, dropout=p, seed=20231 + tq,
                            plain=plain), (q, k, v), dout))
                    torch.cuda.synchronize()
                kern, plain_out, again = outs
                check_pair(f"flash {dtype_name:8s} {name} B={b} ({tq},{tk}) D={dh} "
                           f"causal={int(causal)} p={p}", ("out", "dq", "dk", "dv"), kern, plain_out, dtype_name,
                           worst, "flash")
                if not all(torch.equal(a, c) for a, c in zip(kern, again)):
                    raise AssertionError(f"flash {name}: two runs of the kernels differ in bits")
        for name, n, d in ln_cases:
            for p in (0.0, 0.1):
                x, h, gamma, beta, dy = ln_inputs(n, d, dtype, device, seed=n)
                outs = []
                for plain in (False, True, False):
                    outs.append(run_with_grads(
                        lambda x_, h_, g_, b_: residual_dropout_layernorm(
                            x_, h_, g_, b_, dropout=p, seed=777 + n, plain=plain),
                        (x, h, gamma, beta), dy))
                    torch.cuda.synchronize()
                kern, plain_out, again = outs
                check_pair(f"fused_ln {dtype_name:8s} {name} N={n} D={d} p={p}",
                           ("y", "dx", "dh", "dgamma", "dbeta"), kern, plain_out, dtype_name,
                           worst, "ln")
                if not all(torch.equal(a, c) for a, c in zip(kern, again)):
                    raise AssertionError(f"fused_ln {name}: two runs of the kernels differ in bits")
    log("[kernel] every backward gave the same bits on a second run")
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


# ------------------------------------------------------------ training path

# synthetic batches with the length statistics of LJSpeech (13,100 clips in
# ~24 h: 566 +- 120 mel frames at hop 256 / 22.05 kHz, 95 +- 25 phonemes),
# padded to one mel and one phoneme bucket
MEL_MEAN, MEL_STD, MEL_BUCKET = 566, 120, 768
PHON_MEAN, PHON_STD, PHON_BUCKET = 95, 25, 128
TRAIN_STEPS = 3  # checked optimizer steps (the timed ones come after)
# launches of one train-mode forward and of its backward: 3 encoder + 6
# decoder attention calls, 6 encoder + 9 decoder LN(x + Drop(h)) calls
ATTN_CALLS, LN_CALLS = 9, 15
# train-parity, fp32: kernels and plain versions do the same arithmetic on
# the same kept elements in another summation order, through ~30 layers
# forward and back.  Losses: relative.  A gradient: max abs error against the
# tensor's largest entry, with a floor of 1e-4 of the global norm for tensors
# whose true gradient is (near) zero, such as the key-projection biases.
PARITY_LOSS_TOL, PARITY_GRAD_TOL, PARITY_GRAD_FLOOR = 1e-4, 1e-3, 1e-4


def synthetic_batch(rng, k: int, b: int) -> dict:
    """k micro-batches of b rows at the bucket shapes, ragged lengths."""
    mel_lens = np.clip(rng.normal(MEL_MEAN, MEL_STD, (k, b)).astype(np.int32), 200, MEL_BUCKET)
    phon_lens = np.clip(rng.normal(PHON_MEAN, PHON_STD, (k, b)).astype(np.int32), 30, PHON_BUCKET)
    return {
        "phoneme": rng.integers(1, 80, (k, b, PHON_BUCKET)).astype(np.int32),
        "melspec": (rng.standard_normal((k, b, MEL_BUCKET, 80)) * 0.8).astype(np.float32),
        "phoneme_lens": phon_lens,
        "melspec_lens": mel_lens,
    }


def train_counters() -> dict:
    from transformertts_tpu_torch.ops.flash_attention import flash_attention
    from transformertts_tpu_torch.ops.fused_ln import residual_dropout_layernorm

    return {"flash_fwd": flash_attention.launches_fwd, "flash_bwd": flash_attention.launches_bwd,
            "ln_fwd": residual_dropout_layernorm.launches_fwd,
            "ln_bwd": residual_dropout_layernorm.launches_bwd}


def zero_train_counters() -> None:
    from transformertts_tpu_torch.ops.flash_attention import flash_attention
    from transformertts_tpu_torch.ops.fused_ln import residual_dropout_layernorm

    flash_attention.launches_fwd = flash_attention.launches_bwd = 0
    residual_dropout_layernorm.launches_fwd = residual_dropout_layernorm.launches_bwd = 0


def expected_train_launches(passes_fwd: int, passes_bwd: int) -> dict:
    return {"flash_fwd": ATTN_CALLS * passes_fwd, "flash_bwd": ATTN_CALLS * passes_bwd,
            "ln_fwd": LN_CALLS * passes_fwd, "ln_bwd": LN_CALLS * passes_bwd}


def train_model(cfg, device, seed: int, plain_ops: bool = False):
    import torch

    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.models.factory import runtime_model_kwargs

    gen = torch.Generator().manual_seed(seed)
    model = TransformerTTS(cfg.model, generator=gen,
                           **runtime_model_kwargs(cfg, device, plain_ops=plain_ops))
    perturb_(model, gen)
    return model


def phase_train_parity(cfg, device, batch_rows: int = TRAIN_B) -> None:
    """One fp32 micro-batch through the kernels and through their plain
    versions, same seeds: losses and every parameter's gradient."""
    import dataclasses

    import torch

    from transformertts_tpu_torch.train import create_train_state, make_train_step
    from transformertts_tpu_torch.train.train_step import AdamNoam

    class Recorder(AdamNoam):
        """Keeps the averaged gradients it is handed and updates nothing."""

        def apply_(self, params, grads, state, grad_norm):
            self.grads = {k: g.detach().clone() for k, g in grads.items()}

    c32 = cfg.replace(runtime=dataclasses.replace(cfg.runtime, compute_dtype="float32"))
    batch = synthetic_batch(np.random.default_rng(11), 1, batch_rows)
    runs = []
    for plain in (False, True):
        model = train_model(c32, device, seed=3, plain_ops=plain)
        opt = Recorder(c32.model.d_model, c32.training.warmup_steps, 1.0, 0.0)
        state = create_train_state(model, c32, opt)
        zero_train_counters()
        _, metrics = make_train_step(model, c32, opt)(
            state, batch, 0.5, torch.Generator().manual_seed(5))
        if device.type == "cuda":
            torch.cuda.synchronize()
        counts = train_counters()
        want = expected_train_launches(0, 0) if plain else expected_train_launches(2, 1)
        if device.type == "cuda" and counts != want:
            raise AssertionError(f"train-parity plain={plain}: launches {counts}, expected {want}")
        runs.append(({k: float(v) for k, v in metrics.items()}, opt.grads))
    (km, kg), (pm, pg) = runs
    for name in ("total", "pred_mel", "post_mel", "stop", "grad_norm"):
        rel = abs(km[name] - pm[name]) / max(abs(pm[name]), 1e-12)
        if not rel <= PARITY_LOSS_TOL:
            raise AssertionError(f"train-parity: {name} kernel {km[name]} != plain {pm[name]}")
    norm = pm["grad_norm"]
    worst, worst_name = 0.0, ""
    for name, ref in pg.items():
        err = float((kg[name] - ref).abs().max())
        ratio = err / max(float(ref.abs().max()), PARITY_GRAD_FLOOR * norm)
        if ratio > worst:
            worst, worst_name = ratio, name
        if not ratio <= PARITY_GRAD_TOL:
            raise AssertionError(f"train-parity: gradient of {name} off by {ratio:.3g} of its "
                                 f"largest entry (abs {err:.3g})")
    log(f"[train-parity] fp32 B={batch_rows} dropout on, p_tf 0.5: loss kernel {km['total']:.6f} "
        f"plain {pm['total']:.6f}, grad_norm {km['grad_norm']:.6f} / {pm['grad_norm']:.6f}, "
        f"{len(pg)} gradients within {PARITY_GRAD_TOL:g} of their largest entry "
        f"(worst {worst:.2e}, {worst_name})")


def profile_step(run_step, step_ms: float, card: str, top: int = 14) -> None:
    """One optimizer step under ``torch.profiler``: device time by kernel
    name, and the device's busy time beside ``step_ms``, the time of a step
    without the profiler (whose own start-up makes its step far longer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0)
            slot = by_name.setdefault(e.name, [0.0, 0])
            slot[0] += us
            slot[1] += 1
    busy_ms = sum(v[0] for v in by_name.values()) / 1e3
    if busy_ms <= 0.0:
        raise AssertionError("the profiler recorded no device time")
    log(f"[profile] one train step under the profiler: device busy {busy_ms:.1f} ms in "
        f"{sum(v[1] for v in by_name.values())} kernels and copies, {100 * busy_ms / step_ms:.1f} % "
        f"of the {step_ms:.1f} ms a step takes without the profiler [{card}]")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"[profile] {us / 1e3:8.2f} ms {100 * us / 1e3 / busy_ms:5.1f} % {count:6d} x {name[:90]}")


def phase_train(cfg, device, card: str, timed_steps: int = 4, profile: bool = False) -> dict:
    """The training path; returns the launch counts of its checked steps and
    the timed steps' ms per step."""
    import math

    import torch

    from transformertts_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    k, b = cfg.training.grad_acc_steps, cfg.training.batch_size
    model = train_model(cfg, device, seed=7)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, k, b) for _ in range(2)]
    before = {name: t.detach().clone() for name, t in model.state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    on_card = device.type == "cuda"

    zero_train_counters()
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, batches[i % 2], 0.8, gen)
        m = {name: float(v) for name, v in metrics.items()}
        if not (math.isfinite(m["total"]) and math.isfinite(m["grad_norm"])) or m["skipped"]:
            raise AssertionError(f"train step {i}: {m}")
        log(f"[train] step {i}: loss {m['total']:.4f} (pred {m['pred_mel']:.4f}, post "
            f"{m['post_mel']:.4f}, stop {m['stop']:.4f}), grad_norm {m['grad_norm']:.4f}")
    counts = train_counters()
    want = expected_train_launches(2 * k * TRAIN_STEPS, k * TRAIN_STEPS)
    if on_card and counts != want:
        raise AssertionError(f"train: launches {counts}, the path implies {want}")
    if state.step != TRAIN_STEPS or state.opt_state["count"] != TRAIN_STEPS:
        raise AssertionError("the optimizer did not take every step")
    after = model.state_dict()
    same_w = [n for n, t in before.items() if t.ndim >= 2 and torch.equal(t, after[n])]
    same_bn = [n for n, t in before.items() if "running_" in n and torch.equal(t, after[n])]
    if same_w or same_bn:
        raise AssertionError(f"unchanged after {TRAIN_STEPS} steps: {same_w + same_bn}")

    # evaluation: the cross-attention returns its weights there (plain path by
    # design, as in the JAX package), so 6 flash and 15 LN forwards
    zero_train_counters()
    ev = make_eval_step(model, cfg)(state, {name: x[0] for name, x in batches[0].items()})
    ev = {name: float(v) for name, v in ev.items()}
    if not all(math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"eval step not finite: {ev}")
    want_eval = {"flash_fwd": 6, "flash_bwd": 0, "ln_fwd": LN_CALLS, "ln_bwd": 0}
    if on_card and train_counters() != want_eval:
        raise AssertionError(f"eval: launches {train_counters()}, expected {want_eval}")
    log(f"[train] eval step: loss {ev['total']:.4f}, mel_l1 {ev['mel_l1']:.4f}, mcd "
        f"{ev['mcd']:.3f}, diagonality {ev['diagonality']:.4f}")
    log(f"[train] kernel launches over {TRAIN_STEPS} optimizer steps of {k} micro-batches: {counts}")

    step_ms = float("nan")
    if on_card and timed_steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(timed_steps):
            state, metrics = step(state, batches[i % 2], 0.8, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        frames = sum(int(batches[i % 2]["melspec_lens"].sum()) for i in range(timed_steps))
        audio_s = frames * cfg.audio.hop_length / cfg.audio.sample_rate
        step_ms = dt / timed_steps * 1e3
        log(f"[time] train step (bf16, {k} x {b} rows, mel {MEL_BUCKET}, phonemes {PHON_BUCKET}, "
            f"double forward, dropout on): {step_ms:.1f} ms/step over {timed_steps} steps, "
            f"{audio_s / dt:.0f} audio-s/s ({audio_s / timed_steps:.0f} audio-s per step), peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if on_card and profile and timed_steps:
        profile_step(lambda: step(state, batches[0], 0.8, gen), step_ms, card)
    return {"launches": counts, "step_ms": step_ms}


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def phase_time_train(device, card: str) -> dict:
    """Rows 3-6 at the training path's shapes, bf16, dropout 0.1: kernel and
    library call (dropout 0; its backward through autograd) as device time
    per call (CUDA-graph replay), the plain version between events around
    eager calls."""
    import torch
    import torch.nn.functional as F

    from transformertts_tpu_torch.models.masks import NEG_INF
    from transformertts_tpu_torch.ops import flash_attention as fa
    from transformertts_tpu_torch.ops import fused_ln as ln

    dtype, p, es = torch.bfloat16, 0.1, 2
    b, h, dh, d = TRAIN_B, TRAIN_H, TRAIN_DH, TRAIN_D
    rows = {}

    def report(kernel, shape, ms, plain, bound, by, lib, note):
        rows[(kernel, shape)] = (ms, plain, bound, by, lib)
        log(f"[time] bf16 {kernel} {shape} {note}: kernel {ms * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by}), library "
            f"{lib * 1e3:.1f} us [{card}]")

    for name, (tq, tk, causal) in ATTN_SHAPES.items():
        q, k, v, dout, bias = attn_inputs(b, h, tq, tk, dh, dtype, device, seed=tq + tk)
        args = (dh ** -0.5, causal, p, fa.pick_block(tq, tk))
        out, m, l = fa.flash_forward(q, k, v, bias, 99, *args)
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        fwd = device_ms(lambda: fa.flash_forward(q, k, v, bias, 99, *args))
        bwd = device_ms(lambda: fa.flash_backward(q, k, v, bias, 99, out, dout, m, l, *args))
        plain_fwd = time_ms(lambda: fa.flash_attention_reference(
            t(q), t(k), t(v), bias, 99, *args), 5, 2)
        plain_bwd = time_ms(lambda: fa.flash_attention_backward_reference(
            t(q), t(k), t(v), bias, 99, t(out), t(dout), m, l, *args), 5, 2)
        # the library call, dropout 0: one additive mask of key padding (+ causal)
        mask = bias[:, None, None, :].expand(b, 1, tq, tk)
        if causal:
            mask = mask + torch.triu(torch.full((tq, tk), NEG_INF, device=device), 1)
        mask = mask.to(dtype).contiguous()
        lq, lk, lv = (t(x).detach().requires_grad_(True) for x in (q, k, v))
        lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
            lq.detach(), lk.detach(), lv.detach(), attn_mask=mask))
        lib_bwd = device_ms(
            lambda lout: torch.autograd.grad(lout, (lq, lk, lv), t(dout), retain_graph=True),
            setup=lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask))
        # what this run's data needs: the (row, key) pairs that are not masked
        valid = (bias > 0.5 * NEG_INF)[:, None, :].expand(b, tq, tk)
        if causal:
            valid = valid & torch.ones(tq, tk, dtype=torch.bool, device=device).tril()
        pairs = float(valid.sum()) * h
        qo, kv, stats = b * tq * h * dh * es, b * tk * h * dh * es, b * h * tq * 4
        f_bound, f_by = bound_ms(2 * qo + 2 * kv + 4 * b * tk + 2 * stats, 4 * pairs * dh,
                                 PEAK_BF16_FLOPS)
        b_bound, b_by = bound_ms(4 * qo + 4 * kv + 4 * b * tk + 2 * stats, 10 * pairs * dh,
                                 PEAK_BF16_FLOPS)
        shape = f"{name} B={b} H={h} ({tq},{tk}) D={dh} causal={int(causal)}"
        report("flash_fwd", name, fwd, plain_fwd, f_bound, f_by, lib_fwd, shape)
        report("flash_bwd", name, bwd, plain_bwd, b_bound, b_by, lib_bwd, shape)

    for name, n in LN_ROWS.items():
        # four input sets in turn (75 MB at 12,288 rows), so that a call does
        # not find its inputs in the 50 MB L2 cache
        sets = [ln_inputs(n, d, dtype, device, seed=n + i) for i in range(4)]
        rows_m = ln.pick_rows(n, d)
        turn = [0]

        def nxt():
            turn[0] = (turn[0] + 1) % len(sets)
            return sets[turn[0]]

        def k_fwd():
            x, hh, g, be, _ = nxt()
            return ln.fused_ln_forward(x, hh, g, be, 99, p, 1e-5, rows_m)

        def k_bwd():
            x, hh, g, _, dy = nxt()
            return ln.fused_ln_backward(x, hh, g, dy, 99, p, 1e-5, rows_m)

        def p_fwd():
            x, hh, g, be, _ = nxt()
            return ln.residual_dropout_layernorm_reference(x, hh, g, be, 99, p, 1e-5, rows_m)

        def p_bwd():
            x, hh, g, _, dy = nxt()
            return ln.residual_dropout_layernorm_backward_reference(
                x, hh, g, dy, 99, p, 1e-5, rows_m)

        libs = [(x, hh, g.to(dtype).requires_grad_(True), be.to(dtype).requires_grad_(True), dy)
                for x, hh, g, be, dy in sets]

        def l_fwd():
            turn[0] = (turn[0] + 1) % len(libs)
            x, hh, g, be, _ = libs[turn[0]]
            return F.layer_norm(x + hh, (d,), g.detach(), be.detach(), 1e-5)

        lx, lh = (libs[0][i].detach().requires_grad_(True) for i in (0, 1))
        lib_bwd = device_ms(  # one input set: the library finds its inputs in the L2 cache
            lambda ly: torch.autograd.grad(
                ly, (lx, lh, libs[0][2], libs[0][3]), libs[0][4], retain_graph=True),
            setup=lambda: F.layer_norm(lx + lh, (d,), libs[0][2], libs[0][3], 1e-5))
        f_bound, f_by = bound_ms(3 * n * d * es + 2 * d * 4, 10 * n * d, PEAK_FP32_FLOPS)
        b_bound, b_by = bound_ms(5 * n * d * es + 3 * d * 4, 20 * n * d, PEAK_FP32_FLOPS)
        shape = f"N={n} D={d} p={p}"
        report("ln_fwd", name, device_ms(k_fwd), time_ms(p_fwd, 5, 2), f_bound, f_by,
               device_ms(l_fwd), shape)
        report("ln_bwd", name, device_ms(k_bwd), time_ms(p_bwd, 5, 2), b_bound, b_by,
               lib_bwd, shape)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES)
                    + ", for development runs")
    ap.add_argument("--profile", action="store_true",
                    help="after the train and time phases' steps, one more step under "
                         "torch.profiler: device time by kernel and the device's busy share")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if phases - set(ALL_PHASES):
        ap.error(f"unknown phases {sorted(phases - set(ALL_PHASES))}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 1
    import dataclasses

    from transformertts_tpu_torch.config import Config
    from transformertts_tpu_torch.infer import Synthesizer

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain side runs true fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    log(card)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    cfg = Config()
    t_start = time.perf_counter()
    if "build" in phases:
        phase_build()
    if "mask" in phases:
        phase_mask(device)
    worst = phase_kernel(cfg, device) if "kernel" in phases else {}
    train_worst = phase_train_kernels(device) if "kernel" in phases else {}
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
        del synth, gen_model
    if "train-parity" in phases:
        phase_train_parity(cfg, device)
    train = {}
    if "train" in phases:
        train = phase_train(cfg, device, card, timed_steps=4 if "time" in phases else 0,
                            profile=args.profile)
    train_rows = phase_time_train(device, card) if "time" in phases else {}
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    if phases != set(ALL_PHASES):
        log(f"[partial] phases {sorted(phases)} passed; no result for a partial run")
        return 0
    src = "transformertts_tpu_torch/ops/csrc/"
    pallas = "transformertts_tpu/ops/pallas/"
    kernels = []
    for b, name, line, key in ((1, "decode_step", 300, "b1"),
                               (8, "decode_step_batched", 532, "batched")):
        ms, plain, bound, by = rows[(b, SERVE_MAX_LEN, 64, 200)]
        kernels.append({
            "name": f"{name} (B={b}, bf16, n_pos {SERVE_MAX_LEN}, Tp 64, t 200)",
            "route": "cuda", "source": src + "decode_step.cu",
            "replaces": f"{pallas}decode_step.py:{line}",
            "launches": launches[key], "max_abs_err": worst[b],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
    # rows 3-6: the record's numbers are those of the largest shape on the
    # path; "shapes" holds every shape of the path
    for kernel, source, site, count, err, main_shape, what in (
            ("flash_fwd", "flash_attention.cu", "flash_attention.py:167", "flash_fwd",
             ("flash", "fwd"), "dec_self", "B=16 H=4 (768,768) D=64 causal, bf16, p=0.1"),
            ("flash_bwd", "flash_attention.cu", "flash_attention.py:292", "flash_bwd",
             ("flash", "bwd"), "dec_self", "B=16 H=4 (768,768) D=64 causal, bf16, p=0.1"),
            ("ln_fwd", "fused_ln.cu", "fused_ln.py:142", "ln_fwd", ("ln", "fwd"), "decoder",
             "N=12288 D=256, bf16, p=0.1"),
            ("ln_bwd", "fused_ln.cu", "fused_ln.py:178", "ln_bwd", ("ln", "bwd"), "decoder",
             "N=12288 D=256, bf16, p=0.1")):
        ms, plain, bound, by, lib = train_rows[(kernel, main_shape)]
        kernels.append({
            "name": f"{kernel} ({what})", "route": "cuda", "source": src + source,
            "replaces": pallas + site, "launches": train["launches"][count],
            "max_abs_err": train_worst[err], "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": lib,
            "shapes": {shape: dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"), r))
                       for (kern, shape), r in train_rows.items() if kern == kernel},
        })
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError("a kernel of the path was launched no time on the main path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
