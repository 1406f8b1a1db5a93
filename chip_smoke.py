#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--phases build,kernel,...] [--profile]

Phases, each of which fails the run (non-zero exit) when it fails:

1. build: the CUDA kernels of ``transformertts_tpu_torch/ops/csrc`` with
   nvcc, one process per source, all at once; for the decode-step, flash,
   fused-FFN and fused-LN libraries each kernel's registers and spills,
   ptxas's warnings of serialized wgmma, the dynamic shared memory at the
   path shapes (the decode step at ``Config()`` and ``paper.yaml`` widths),
   and the HGMMA (wgmma) instructions in the SASS (where cuobjdump exists;
   the tensor-core kernels must hold some);
2. mask: the device ``keep_mask`` against its plain version, bit for bit;
3. kernel: every kernel against its plain PyTorch version on the card.
   The decode-step kernel (``decode_step_reference``) at the full width of
   ``Config()`` (d_model 256, 3 layers, 4 heads, d_ffn 1024, 80 mels): B in
   {1, 8}, t in {0, 1, 700} with 1,500 cache positions and 192 encoder
   positions, the expected-position output off and on, bf16 and fp32, plus
   the serving shape (400 positions, 64 encoder positions); and at
   ``configs/paper.yaml`` widths (d_model 512, 6 layers, 8 heads, d_ffn
   2,048): B in {1, 8}, t in {0, 700, 1,499}, the same positions, output
   and dtypes.  Each case is called twice for equal bits, and one call
   under ``torch.profiler`` must be exactly one kernel launch.  The flash
   attention and residual+dropout+LayerNorm kernels, forward and every
   gradient, at the training path's shapes (B 16, 4 heads of 64; (128, 128),
   causal (768, 768), (768, 128); 12,288 and 2,048 rows of 256) and at odd
   ones (LN: 1,000 and 24 rows, mask blocks shorter than the backward's
   runs of rows), fp32 and bf16, dropout 0 and 0.1, ragged key bias; flash also with
   mask q-blocks of 96 rows at (768, 768), with whole 64-key tiles padded in
   some batch rows, and with one batch row whose keys are all padded; each
   backward twice, for equal bits.  The fused FFN kernels, forward and all five
   gradients, at (N, D, F) = (12,288, 256, 1,024) and (2,048, 256, 1,024) and
   at odd sizes (an N no mask block divides, F no multiple of a slice, N
   and F no multiples of the tensor-core kernels' 64-wide tiles, a
   d_model narrower than a block's 256 output columns, the two wider models
   of ``configs/`` at (512, 2,048) and (1,024, 4,096), a width where bf16 and
   fp32 key the mask on different block heights), fp32 and bf16, dropout 0 and 0.1,
   each backward twice for equal bits.  The log-mel kernel at one clip
   (``center=True``, a length that is no multiple of the hop), at a batch of
   32 rows of 163,840 samples (``center=False``, as ``preprocess`` sends
   them) and at lengths that rule out 16-byte loads, against its plain
   version and against ``mel_spectrogram_np``;
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
   then a second micro-batch the same way with
   ``runtime.use_pallas_fused_ffn`` on;
7. train: the training path, ``create_train_state`` + ``make_train_step``
   at ``Config()`` (bf16, 4 micro-batches of 16 rows, 768 mel frames, 128
   phonemes, double forward, dropout on) for 3 optimizer steps on seeded
   synthetic batches, then one ``make_eval_step``; the kernels' launch
   counts are zeroed before and read after, and must be what the path
   implies (per step 72 / 36 flash and 120 / 60 LayerNorm forwards /
   backwards), fused FFN off as by default;
8. preprocess: the preprocessing path.  A seeded corpus of 160 mono 16-bit
   wavs of 2-9 s at 22,050 Hz (moving sines and noise; ids in both splits)
   with a ``metadata.csv`` is written into a temporary directory, the
   port's ``preprocess`` runs on it with ``runtime.use_pallas_mel`` on the
   card, and the npz keys, ``stats.json``, every clip's frame count and
   every mel (against ``mel_spectrogram_np`` under the same statistics) are
   checked; the log-mel kernel's launch count is zeroed before and must be
   twice the number of 32-clip chunks after;
9. train-ffn: the training path with ``runtime.use_pallas_fused_ffn`` on.
   The first optimizer step takes a batch that ``BucketedLoader`` over
   ``LJSpeechDataset`` (through ``prefetch``) reads from what the
   preprocess phase wrote, then 3 checked and 4 timed steps on the
   synthetic batches of the train phase, then one evaluation step; per
   optimizer step 48 / 24 FFN forwards / backwards beside the 72 / 36
   flash and 120 / 60 LayerNorm ones;
10. time: the decode-step kernel beside its plain version and its bound
    at ``Config()`` and ``paper.yaml`` widths, with the host's time per eager
    call and the kernel's time by stage (its global-timer stamps), and
    decode frames/s through ``Synthesizer.synthesize``;
11. time-train: every training and preprocessing kernel beside its plain
    version, its bound and (where PyTorch has a call or a short chain of
    calls for the same function) that (flash, the LN and the FFN backward
    also at dropout 0, and flash's host time per eager call), and both
    training configurations' ms per step and audio-seconds per second; all
    timings with the card's name and power limit.

The train phase keeps its 3 checked + 4 timed steps while the whole run stays
near two minutes; it may drop to 1 + 2 if later phases push the run past that.

The last lines are the kernels' JSON record, the card's name and power
limit as nvidia-smi gives them, and ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits with status 1 and prints no result.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16, published
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores, published
ALL_PHASES = ("build", "mask", "kernel", "decode", "serve", "train-parity", "train",
              "preprocess", "train-ffn", "time", "time-train")
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


def default_config():
    from transformertts_tpu_torch.config import Config

    return Config()


def paper_config():
    """``configs/paper.yaml``: d_model 512, 6 + 6 layers, 8 heads, d_ffn 2,048."""
    from pathlib import Path

    from transformertts_tpu_torch.config import load_config

    return load_config(Path(__file__).resolve().parent / "configs" / "paper.yaml")


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
    """Seeded frame, alpha*PE[t], ragged cross bias and caches for one step
    (the caches drawn on the device, in bulk)."""
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
    gen = torch.Generator(device=device).manual_seed(seed)
    caches = [torch.randn((L, H, b, n, dh), generator=gen, device=device).to(dtype)
              for n in (n_pos, n_pos, tp, tp)]
    return [x.to(device) for x in (frame, pe_row, bias)], caches


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


def host_us(fn, n: int = 50) -> float:
    """Host microseconds per call of ``fn`` issued back to back, the device
    drained before and after (what a caller's thread spends to enqueue it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


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
    for name in ("decode_step", "flash_attention", "fused_ffn", "fused_ln"):
        kernel_report(name, libs[name])


def ptxas_kernels(text: str) -> list[tuple[str, int, str]]:
    """(kernel, registers, spill line) of each entry function in an
    ``nvcc -Xptxas -v`` report."""
    rows, name, spill = [], "", ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            rows.append((name, int(ln.split("Used ")[1].split()[0]), spill))
            name = ""
    return rows


def demangle(names: list[str]) -> list[str]:
    """Short readable kernel names (``flash_fwd_tc<64>``) where c++filt exists."""
    import re
    import shutil

    if shutil.which("c++filt") is None:
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()
    found = [re.search(r"::(\w+(?:<[^()]*>)?)\(", o) for o in out]
    return [f.group(1) if f else o for f, o in zip(found, out)]


def smem_lines(name: str) -> list[str]:
    """Dynamic shared memory per block of a library's kernels at the path
    shapes, as the library itself computes it."""
    import ctypes

    if name == "flash_attention":
        from transformertts_tpu_torch.ops import flash_attention as fa

        out = []
        for is_bf16, dtype in ((1, "bf16"), (0, "fp32")):
            smem = (ctypes.c_longlong * 3)()
            if fa._lib().tts_flash_shared_bytes(is_bf16, TRAIN_DH, 768, 768, smem) != 0:
                raise AssertionError("tts_flash_shared_bytes refused D = 64")
            out.append(f"{dtype} D={TRAIN_DH} (768, 768): forward {smem[0]}, dQ {smem[1]}, "
                       f"dK/dV {smem[2]} bytes")
        return out
    if name == "fused_ffn":
        from transformertts_tpu_torch.ops import fused_ffn as ffn

        smem = (ctypes.c_longlong * 3)()
        if ffn._lib().tts_fused_ffn_shared_bytes(TRAIN_D, smem) != 0:
            raise AssertionError("tts_fused_ffn_shared_bytes refused D = 256")
        return [f"D={TRAIN_D}: forward {smem[0]}, bf16 backward dh {smem[1]}, "
                f"gradients {smem[2]} bytes"]
    if name == "decode_step":
        import torch

        from transformertts_tpu_torch.ops.decode_step import _lib, card_plan

        out = []
        for what, cfg in (("Config()", default_config()), ("paper.yaml", paper_config())):
            m = cfg.model
            for dtype in (torch.bfloat16, torch.float32):
                for b in (1, 8):
                    cluster, rows, (_, pieces, lay) = card_plan(
                        m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels,
                        m.n_mels * m.reduction_factor + m.reduction_factor, b, m.decoder_n_head,
                        1500, 192, dtype)
                    held = _lib().tts_decode_step_max_clusters(
                        int(dtype == torch.bfloat16), rows, lay["smem_bytes"], cluster)
                    real = pieces[:, :, 3] < (1 << 30)
                    out.append(
                        f"{what} {str(dtype)[6:]} B={b}, n_pos 1500, Tp 192: {b // rows} "
                        f"cluster(s) of {cluster} blocks x {rows} row(s) ({held} held at once), "
                        f"{lay['smem_bytes']} bytes a block ({lay['ring_bytes']} of them the "
                        f"weight ring), {int(real.sum(0).max())} weight pieces a block, "
                        f"{int((real & (pieces[:, :, 3] >= 0)).sum(0).max())} copied after "
                        f"kernel start")
        return out
    if name == "fused_ln":
        from transformertts_tpu_torch.ops import fused_ln as ln

        return [f"D={TRAIN_D}: backward {ln._lib().tts_fused_ln_bwd_shared_bytes(TRAIN_D)} "
                f"bytes (forward none)"]
    return []


def kernel_report(name: str, path) -> None:
    """A library's kernels: registers and spills of each, dynamic shared
    memory at the path shapes, and HGMMA (wgmma) instructions in the SASS
    where cuobjdump is present."""
    import os
    import shutil

    report = path.with_suffix(".log").read_text()
    rows = ptxas_kernels(report)
    for short, (_, regs, spill) in zip(demangle([r[0] for r in rows]), rows):
        log(f"[build] {name}: {short}: {regs} registers/thread; {spill}")
    # ptxas serializes every wgmma of a function that holds a call, for example
    # to the slow path of a float division
    serialized = [ln.strip() for ln in report.splitlines() if "serialized" in ln]
    log(f"[build] {name}: wgmma serialization warnings: {serialized[:4] or 'none'}")
    for line in smem_lines(name):
        log(f"[build] {name} dynamic shared memory per block, {line}")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        log(f"[build] {name}: cuobjdump not available")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in ln:
            counts[fn] += 1
    per = ", ".join(f"{short} {n}" for short, n in zip(demangle(list(counts)), counts.values()))
    log(f"[build] {name}: {sum(counts.values())} HGMMA instructions in the SASS ({per})")
    for must in {"fused_ffn": ("ffn_dh_tc", "ffn_grad_tc"), "flash_attention": ("_tc",)}.get(name, ()):
        if not any(must in fn and n > 0 for fn, n in counts.items()):
            raise AssertionError(f"{name}: no HGMMA instruction in a kernel named *{must}*")


def check_one_launch(call, name: str) -> None:
    """``call()`` under ``torch.profiler`` launches exactly one kernel, and
    its name holds ``name`` (copies and fills are not kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not any(w in e.name.lower() for w in ("memcpy", "memset"))]
    if len(kernels) != 1 or name not in kernels[0]:
        raise AssertionError(f"one call launched {len(kernels)} kernels: {kernels[:30]}")
    log(f"[kernel] one decode_step call under the profiler: 1 kernel launch ({kernels[0][:80]})")


def phase_kernel(cfg, device) -> dict:
    """Kernel vs plain version at ``Config()`` and ``paper.yaml`` widths,
    each case twice for equal bits; returns the max errors by batch."""
    import torch

    from transformertts_tpu_torch.ops.decode_step import (
        decode_step,
        decode_step_reference,
        pack_decode_weights,
    )

    worst: dict[int, float] = {}
    runs = [("Config()", cfg, [(1500, 192, t) for t in (0, 1, 700)] + [(SERVE_MAX_LEN, 64, 200)]),
            ("paper.yaml", paper_config(), [(1500, 192, t) for t in (0, 700, 1499)])]
    for what, wcfg, cases in runs:
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            model = make_model(wcfg, dtype, device, seed=1)
            packed = pack_decode_weights(model, dtype)
            alpha = float(model.pe.alpha.detach())
            del model
            for b in (1, 8):
                for n_pos, tp, t in cases:
                    (frame, pe_row, bias), caches = step_inputs(
                        wcfg, b, t, n_pos, tp, dtype, device, seed=b * 1000 + t)
                    pe_row = alpha * pe_row
                    for with_pos in (False, True):
                        work = [c.clone() for c in caches]
                        out = decode_step(t, frame, pe_row, bias, *work, packed,
                                          with_attn_pos=with_pos)
                        again = decode_step(t, frame, pe_row, bias, *work, packed,
                                            with_attn_pos=with_pos)
                        torch.cuda.synchronize()
                        if not all(torch.equal(x, y) for x, y in zip(out, again)):
                            raise AssertionError(f"{what} {dtype_name} B={b} t={t}: a second "
                                                 f"call gave other bits")
                        ref = decode_step_reference(t, frame, pe_row, bias, *caches, packed,
                                                    with_pos)
                        errs = []
                        for name, o, r in zip(("y", "k_new", "v_new", "pos"), out, ref):
                            err, rel = rel_err(o, r)
                            errs.append(f"{name} {err:.2e}")
                            worst[b] = max(worst.get(b, 0.0), err)
                            if not rel <= TOL[dtype_name]:
                                raise AssertionError(
                                    f"kernel != plain: {what} {dtype_name} B={b} t={t} "
                                    f"n_pos={n_pos} tp={tp} pos={with_pos} {name}: rel err {rel:.3g}")
                        for c, new, orig in ((work[0], out[1], caches[0]),
                                             (work[1], out[2], caches[1])):
                            if not torch.equal(c[:, :, :, t], new):
                                raise AssertionError("kernel did not write the new row at t")
                            keep = torch.arange(n_pos, device=device) != t
                            if not torch.equal(c[:, :, :, keep], orig[:, :, :, keep]):
                                raise AssertionError("kernel changed cache rows other than t")
                        if not all(torch.isfinite(o).all() for o in out):
                            raise AssertionError("kernel output not finite")
                        log(f"[kernel] {what} {dtype_name:8s} B={b} t={t:4d} n_pos={n_pos} "
                            f"tp={tp} pos={int(with_pos)}: " + ", ".join(errs) + ", equal bits")
                    del work, caches
            if what == "Config()" and dtype_name == "bfloat16":
                (frame, pe_row, bias), caches = step_inputs(
                    wcfg, 1, 200, SERVE_MAX_LEN, 64, dtype, device, seed=5)
                check_one_launch(
                    lambda: decode_step(200, frame, pe_row, bias, *caches, packed),
                    "decode_step_kernel")
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


def key_bias(lens, tk: int):
    """(B, Tk) fp32 additive key bias: 0 on each row's first lens[i] keys, -1e9 after."""
    import torch

    from transformertts_tpu_torch.models.masks import NEG_INF

    return torch.from_numpy(np.where(np.arange(tk)[None, :] < np.asarray(lens)[:, None], 0.0,
                                     NEG_INF).astype(np.float32))


def attn_inputs(b, h, tq, tk, dh, dtype, device, seed):
    """Seeded q, k, v as one fused (B, T, 3 H dh) projection would leave them
    (strided views when Tq == Tk), dO, and a ragged key bias."""
    import torch

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
    return q, k, v, dout, key_bias(lens, tk).to(device)


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
    # (name, B, H, Tq, Tk, causal, D, mask q-block height, key lengths): None
    # takes the TPU kernel's q-block and attn_inputs' random lengths
    attn_cases = [(name, TRAIN_B, TRAIN_H, *shape, TRAIN_DH, None, None)
                  for name, shape in ATTN_SHAPES.items()]
    attn_cases += [("enc_self_causal", TRAIN_B, TRAIN_H, 128, 128, True, TRAIN_DH, None, None),
                   ("dec_self_full", TRAIN_B, TRAIN_H, 768, 768, False, TRAIN_DH, None, None),
                   ("odd", 2, 2, 5, 37, False, TRAIN_DH, None, None),
                   ("odd_causal", 2, 2, 37, 37, True, TRAIN_DH, None, None),
                   # the other head dim the kernel takes
                   ("odd_dh32", 2, 3, 70, 100, False, 32, None, None),
                   # several mask q-blocks, of a height that is no multiple of the
                   # kernel's 64-row tile (the path's shapes take one q-block)
                   ("dec_self_bq96", TRAIN_B, TRAIN_H, 768, 768, True, TRAIN_DH, 96, None),
                   # whole 64-key tiles padded in two batch rows: the kernels skip them
                   ("padded_tiles", 3, TRAIN_H, 768, 768, True, TRAIN_DH, None, (768, 300, 64)),
                   # one batch row with every key padded: uniform weights, nothing skipped
                   ("all_padded_row", 3, 2, 130, 200, False, TRAIN_DH, None, (200, 0, 77))]
    # (name, N, D, mask block height or None for the TPU kernel's)
    ln_cases = [(name, n, TRAIN_D, None) for name, n in LN_ROWS.items()]
    # ragged row counts (the backward's last block partial; fewer rows than
    # warps), mask blocks shorter than a backward block's run of rows (8 at
    # N = 2,048), and one width for each register layout of the kernel
    ln_cases += [("odd", 1000, TRAIN_D, None), ("tiny", 24, TRAIN_D, None),
                 ("encoder_mask6", 2048, TRAIN_D, 6), ("narrow", 100, 64, None),
                 ("wide", 520, 512, None), ("widest", 264, 1024, None)]
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, b, h, tq, tk, causal, dh, block_q, lens in attn_cases:
            for p in (0.0, 0.1):
                q, k, v, dout, bias = attn_inputs(b, h, tq, tk, dh, dtype, device, seed=tq + tk)
                if lens is not None:
                    bias = key_bias(lens, tk).to(device)
                outs = []
                for plain in (False, True, False):
                    outs.append(run_with_grads(
                        lambda q_, k_, v_: flash_attention(
                            q_, k_, v_, bias, causal=causal, dropout=p, seed=20231 + tq,
                            block_q=block_q, plain=plain), (q, k, v), dout))
                    torch.cuda.synchronize()
                kern, plain_out, again = outs
                check_pair(f"flash {dtype_name:8s} {name} B={b} ({tq},{tk}) D={dh} "
                           f"causal={int(causal)} p={p}", ("out", "dq", "dk", "dv"), kern, plain_out, dtype_name,
                           worst, "flash")
                if not all(torch.equal(a, c) for a, c in zip(kern, again)):
                    raise AssertionError(f"flash {name}: two runs of the kernels differ in bits")
        for name, n, d, mask_rows in ln_cases:
            for p in (0.0, 0.1):
                x, h, gamma, beta, dy = ln_inputs(n, d, dtype, device, seed=n)
                outs = []
                for plain in (False, True, False):
                    outs.append(run_with_grads(
                        lambda x_, h_, g_, b_: residual_dropout_layernorm(
                            x_, h_, g_, b_, dropout=p, seed=777 + n, mask_rows=mask_rows,
                            plain=plain),
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

FFN_ROWS = {"decoder": 16 * 768, "encoder": 16 * 128}  # rows of the path's two FFN shapes
TRAIN_F = 1024
AUDIO = dict(sample_rate=22050, n_fft=1024, hop_length=256, win_length=1024, fmin=0.0,
             fmax=8000.0, n_mels=80)  # Config().audio
MEL_BATCH, MEL_BUCKET_LEN = 32, 163840  # preprocess: 32 clips, zero-extended to 5 x 32,768
MEL_TOL_PLAIN = 1e-3  # max|kernel - plain| on the log-mel: the same products, other order
MEL_TOL_NP = (2e-2, 2e-3)  # max and mean |kernel - numpy FFT|: fp32 DFT sums of 1,024 terms


def ffn_inputs(n, d, f, dtype, device, seed):
    """x (N, D), W1 (F, D), b1, W2 (D, F), b2, dy.  x comes in eighths and W1,
    b1 in 64ths of small integers: the first product's sums are then exact in
    fp32 in any order, so kernel and plain version take the same relu
    decisions and what is compared is their arithmetic, not a coin flip at
    hp = 0 (one flipped element moves a gradient row by far more than any
    rounding).  W2, b2 and dy are plain normal numbers."""
    import torch

    rng = np.random.default_rng(seed)
    x = np.clip(np.round(rng.standard_normal((n, d)) * 8), -24, 24) / 8
    w1 = np.clip(np.round(rng.standard_normal((f, d)) * 4), -12, 12) / 64
    b1 = np.round(rng.standard_normal(f) * 6) / 64
    w2, b2 = rng.standard_normal((d, f)) * 0.06, rng.standard_normal(d) * 0.1
    dy = rng.standard_normal((n, d))
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return t(x).to(dtype), t(w1), t(b1), t(w2), t(b2), t(dy).to(dtype)


def phase_ffn_kernels(device) -> dict:
    """Rows 7-8 against their plain versions; returns the worst abs errors."""
    import torch

    from transformertts_tpu_torch.ops.fused_ffn import fused_ffn, pick_rows

    worst: dict = {}
    cases = [(name, n, TRAIN_D, TRAIN_F, None) for name, n in FFN_ROWS.items()]
    # an N that no mask block divides with an F that is no multiple of a slice;
    # an N and an F that are no multiples of the bf16 backward's 64-wide tiles
    # (and an F that is no multiple of 8);
    # a d_model that rides in a block's 256 output columns; a d_ffn where bf16
    # and fp32 pick other mask heights; and the two wider models of configs/,
    # which take 2 and 4 groups of 256 output columns (paper.yaml has a mask
    # geometry in bf16 only and large_tp.yaml none, so the height is given)
    cases += [("odd", 1001, TRAIN_D, 1000, None), ("ragged", 130, 64, 196, None),
              ("narrow", 520, 192, 264, None),
              ("tall", 192, TRAIN_D, 3072, None),
              ("paper", 1000, 512, 2048, pick_rows(1000, 512, 2048, 2)),
              ("large", 264, 1024, 4096, 8)]
    if pick_rows(192, TRAIN_D, 3072, 2) == pick_rows(192, TRAIN_D, 3072, 4):
        raise AssertionError("the 'tall' case no longer separates the dtypes' mask heights")
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, n, d, f, mask_rows in cases:
            for p in (0.0, 0.1):
                *inputs, dy = ffn_inputs(n, d, f, dtype, device, seed=n + f)
                outs = []
                for plain in (False, True, False):
                    outs.append(run_with_grads(
                        lambda *a: fused_ffn(*a, dropout=p, seed=4242 + n, mask_rows=mask_rows,
                                             plain=plain),
                        inputs, dy))
                    torch.cuda.synchronize()
                kern, plain_out, again = outs
                check_pair(f"fused_ffn {dtype_name:8s} {name} N={n} D={d} F={f} p={p}",
                           ("y", "dx", "dw1", "db1", "dw2", "db2"), kern, plain_out, dtype_name,
                           worst, "ffn")
                if not all(torch.equal(a, c) for a, c in zip(kern, again)):
                    raise AssertionError(f"fused_ffn {name}: two runs of the kernels differ in bits")
    log("[kernel] every fused FFN backward gave the same bits on a second run")
    return worst


def clip_signal(rng, n: int) -> np.ndarray:
    """n samples of two moving sines and noise, within [-1, 1]."""
    t = np.arange(n) / AUDIO["sample_rate"]
    f0, f1 = rng.uniform(100.0, 400.0), rng.uniform(800.0, 3000.0)
    y = (0.3 * np.sin(2 * np.pi * (f0 * t + 40.0 * np.sin(2 * np.pi * 0.7 * t)))
         + 0.2 * np.sin(2 * np.pi * (f1 * t + 0.5 * 300.0 * t * t))
         + 0.05 * rng.standard_normal(n))
    return y.astype(np.float32)


def padded_batch(clips, bucket: int) -> np.ndarray:
    """Clips reflect-padded one by one and zero-extended to ``bucket``
    samples, as ``preprocess`` sends them to the kernel."""
    pad = AUDIO["n_fft"] // 2
    batch = np.zeros((len(clips), bucket), np.float32)
    for j, y in enumerate(clips):
        batch[j, : len(y) + 2 * pad] = np.pad(y, pad, mode="reflect")
    return batch


def check_mel(tag, out, plain, refs, worst) -> None:
    """The kernel's (B, n_mels, frames) against its plain version and, over
    each clip's true frames, against the numpy FFT reference."""
    import torch

    if out.shape != plain.shape or not torch.isfinite(out).all():
        raise AssertionError(f"log_mel {tag}: shape {tuple(out.shape)} or values are off")
    err = float((out - plain).abs().max())
    worst["plain"] = max(worst.get("plain", 0.0), err)
    if not err <= MEL_TOL_PLAIN:
        raise AssertionError(f"kernel != plain: log_mel {tag}: abs err {err:.3g}")
    host = out.cpu().numpy()
    np_max = np_mean = 0.0
    for j, ref in enumerate(refs):
        diff = np.abs(host[j, :, : ref.shape[1]] - ref)
        np_max, np_mean = max(np_max, float(diff.max())), max(np_mean, float(diff.mean()))
    worst["numpy"] = max(worst.get("numpy", 0.0), np_max)
    if not (np_max <= MEL_TOL_NP[0] and np_mean <= MEL_TOL_NP[1]):
        raise AssertionError(f"log_mel {tag} != numpy FFT: max {np_max:.3g}, mean {np_mean:.3g}")
    log(f"[kernel] log_mel {tag}: {tuple(out.shape)}, vs plain {err:.2e}, vs numpy FFT over "
        f"{len(refs)} clips max {np_max:.2e} mean {np_mean:.2e}")


def phase_mel_kernel(device) -> dict:
    """Row 9 against its plain version and the numpy FFT; worst abs errors."""
    import torch

    from transformertts_tpu_torch.dsp import mel_spectrogram_np
    from transformertts_tpu_torch.ops.stft import log_mel

    worst: dict = {}
    rng = np.random.default_rng(9)
    hop = AUDIO["hop_length"]
    # one clip, center=True, 5 s: 110,250 samples, no multiple of the hop
    y = clip_signal(rng, 110250)
    t = torch.from_numpy(y).to(device)
    out = log_mel(t, **AUDIO)
    if out.shape != (AUDIO["n_mels"], 1 + len(y) // hop):
        raise AssertionError(f"log_mel: {tuple(out.shape)} for {len(y)} samples")
    check_mel("one clip, center", out[None], log_mel(t, plain=True, **AUDIO)[None],
              [mel_spectrogram_np(y, **AUDIO)], worst)
    # the batch preprocess sends: 32 clips of 2-7.3 s in one 163,840-sample bucket
    clips = [clip_signal(rng, int(n)) for n in rng.integers(44100, MEL_BUCKET_LEN - 1024, MEL_BATCH)]
    t = torch.from_numpy(padded_batch(clips, MEL_BUCKET_LEN)).to(device)
    out = log_mel(t, center=False, **AUDIO)
    if out.shape != (MEL_BATCH, AUDIO["n_mels"], 1 + (MEL_BUCKET_LEN - 1024) // hop):
        raise AssertionError(f"log_mel: {tuple(out.shape)} for the batch")
    check_mel(f"batch of {MEL_BATCH}, center=False", out, log_mel(t, center=False, plain=True, **AUDIO),
              [mel_spectrogram_np(c, **AUDIO) for c in clips], worst)
    # rows whose starts rule out 16-byte loads (odd padded length), center=True
    clips = [clip_signal(rng, 40001) for _ in range(3)]
    t = torch.from_numpy(np.stack(clips)).to(device)
    check_mel("3 clips of 40,001, center", log_mel(t, **AUDIO), log_mel(t, plain=True, **AUDIO),
              [mel_spectrogram_np(c, **AUDIO) for c in clips], worst)
    torch.cuda.synchronize()
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


def log_stage_times(what, b, t, step_args, packed, card: str, calls: int = 20) -> None:
    """The decode kernel's time by stage at one shape: the median over
    ``calls`` calls of each stage's work (slowest block) and grid-barrier
    wait, from the kernel's global-timer stamps."""
    import statistics

    import torch

    from transformertts_tpu_torch.ops.decode_step import _prepared_step, stage_times

    frame, pe_row, bias, caches = step_args
    step = _prepared_step(*caches, packed, False)
    names = step.stages(t)
    runs = []
    for _ in range(calls):
        tl = step.timeline_buffer()
        step(t, frame, pe_row, bias, timeline=tl)
        torch.cuda.synchronize()
        runs.append(stage_times(tl, len(names) - 1))
    med = [(statistics.median(r[i][0] for r in runs), statistics.median(r[i][1] for r in runs))
           for i in range(len(names))]
    work, wait = sum(m[0] for m in med), sum(m[1] for m in med)
    log(f"[time] {what} bf16 B={b} t={t} by stage (median of {calls} calls, global timer): "
        f"{len(names)} stages, work {work:.1f} us, barrier waits {wait:.1f} us "
        f"({wait / max(1, len(names) - 1):.2f} us each) [{card}]")
    log("[time]   " + ", ".join(f"{n} {w:.2f}+{x:.2f}" for n, (w, x) in zip(names, med)))


def phase_time(cfg, device, synth, card: str) -> dict:
    import torch

    from transformertts_tpu_torch.ops.decode_step import (
        decode_step,
        decode_step_reference,
        pack_decode_weights,
    )

    from transformertts_tpu_torch.ops import decode_step as decode_module

    stamps = hasattr(decode_module, "stage_times")  # (an earlier kernel in a same-call A/B has none)
    rows = {}
    for what, wcfg, shapes in (
            ("Config()", cfg, [(1500, 192, 0), (1500, 192, 700), (SERVE_MAX_LEN, 64, 200)]),
            ("paper.yaml", paper_config(), [(1500, 192, 700), (SERVE_MAX_LEN, 64, 200)])):
        model = make_model(wcfg, torch.bfloat16, device, seed=1)
        packed = pack_decode_weights(model, torch.bfloat16)
        del model
        for b in (1, 8):
            for n_pos, tp, t in shapes:
                (frame, pe_row, bias), caches = step_inputs(
                    wcfg, b, t, n_pos, tp, torch.bfloat16, device, seed=7)
                kern = lambda: decode_step(t, frame, pe_row, bias, *caches, packed)  # noqa: E731
                plain = lambda: decode_step_reference(  # noqa: E731
                    t, frame, pe_row, bias, *caches, packed)
                call = time_ms(kern, 200, 10)  # back-to-back calls: host launch cost included
                host = host_us(kern)
                ms, plain_ms = device_ms(kern), device_ms(plain, n=5, reps=4)
                nbytes, flops = step_bytes_flops(packed, b, t, tp, wcfg)
                bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
                by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_BF16_FLOPS else "operations"
                rows[(what, b, n_pos, tp, t)] = (ms, plain_ms, bound, by)
                if (n_pos, tp, t) in ((SERVE_MAX_LEN, 64, 200), (1500, 192, 700)) and stamps:
                    log_stage_times(what, b, t, (frame, pe_row, bias, caches), packed, card)
                log(f"[time] {what} bf16 B={b} n_pos={n_pos} tp={tp} t={t}: kernel "
                    f"{ms * 1e3:.1f} us/step on the device ({call * 1e3:.1f} us per eager call "
                    f"back to back, {host:.1f} us of host time), plain {plain_ms * 1e3:.1f} "
                    f"us/step, bound {bound * 1e3:.2f} us ({by}, {nbytes / 1e6:.2f} MB) [{card}]")
            del caches
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
FFN_CALLS = 6  # with runtime.use_pallas_fused_ffn: one fused call per layer, 3 + 3
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
    from transformertts_tpu_torch.ops.fused_ffn import fused_ffn
    from transformertts_tpu_torch.ops.fused_ln import residual_dropout_layernorm

    return {"flash_fwd": flash_attention.launches_fwd, "flash_bwd": flash_attention.launches_bwd,
            "ln_fwd": residual_dropout_layernorm.launches_fwd,
            "ln_bwd": residual_dropout_layernorm.launches_bwd,
            "ffn_fwd": fused_ffn.launches_fwd, "ffn_bwd": fused_ffn.launches_bwd}


def zero_train_counters() -> None:
    from transformertts_tpu_torch.ops.flash_attention import flash_attention
    from transformertts_tpu_torch.ops.fused_ffn import fused_ffn
    from transformertts_tpu_torch.ops.fused_ln import residual_dropout_layernorm

    flash_attention.launches_fwd = flash_attention.launches_bwd = 0
    residual_dropout_layernorm.launches_fwd = residual_dropout_layernorm.launches_bwd = 0
    fused_ffn.launches_fwd = fused_ffn.launches_bwd = 0


def expected_train_launches(passes_fwd: int, passes_bwd: int, ffn: bool) -> dict:
    return {"flash_fwd": ATTN_CALLS * passes_fwd, "flash_bwd": ATTN_CALLS * passes_bwd,
            "ln_fwd": LN_CALLS * passes_fwd, "ln_bwd": LN_CALLS * passes_bwd,
            "ffn_fwd": FFN_CALLS * passes_fwd * ffn, "ffn_bwd": FFN_CALLS * passes_bwd * ffn}


def with_fused_ffn(cfg):
    import dataclasses

    return cfg.replace(runtime=dataclasses.replace(cfg.runtime, use_pallas_fused_ffn=True))


def train_model(cfg, device, seed: int, plain_ops: bool = False):
    import torch

    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.models.factory import runtime_model_kwargs

    gen = torch.Generator().manual_seed(seed)
    model = TransformerTTS(cfg.model, generator=gen,
                           **runtime_model_kwargs(cfg, device, plain_ops=plain_ops))
    perturb_(model, gen)
    return model


def phase_train_parity(cfg, device, batch_rows: int = TRAIN_B, batch_seed: int = 11) -> None:
    """One fp32 micro-batch through the kernels and through their plain
    versions, same seeds: losses and every parameter's gradient.  ``cfg``
    decides whether the feed-forward blocks are the fused op."""
    import dataclasses

    import torch

    from transformertts_tpu_torch.train import create_train_state, make_train_step
    from transformertts_tpu_torch.train.train_step import AdamNoam

    class Recorder(AdamNoam):
        """Keeps the averaged gradients it is handed and updates nothing."""

        def apply_(self, params, grads, state, grad_norm):
            self.grads = {k: g.detach().clone() for k, g in grads.items()}

    c32 = cfg.replace(runtime=dataclasses.replace(cfg.runtime, compute_dtype="float32"))
    ffn = cfg.runtime.use_pallas_fused_ffn
    batch = synthetic_batch(np.random.default_rng(batch_seed), 1, batch_rows)
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
        want = expected_train_launches(0, 0, ffn) if plain else expected_train_launches(2, 1, ffn)
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
    log(f"[train-parity] fp32 B={batch_rows} fused FFN {'on' if ffn else 'off'}, dropout on, "
        f"p_tf 0.5: loss kernel {km['total']:.6f} "
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
    flash = [v for name, v in by_name.items() if "flash_" in name]
    log(f"[profile] flash attention kernels: {sum(v[0] for v in flash) / 1e3:.2f} ms in "
        f"{sum(v[1] for v in flash)} kernels, {100 * sum(v[0] for v in flash) / 1e3 / busy_ms:.1f} % "
        f"of the device's busy time")
    for what, keys in (("fused LN forward", ("ln_fwd_kernel",)), ("fused LN backward", ("ln_bwd_kernel",)),
                       ("fused FFN forward", ("ffn_fwd_kernel",)),
                       ("fused FFN backward", ("ffn_dx", "ffn_dw", "ffn_dh", "ffn_grad", "ffn_reduce",
                                               "ffn_cast"))):
        sel = [v for name, v in by_name.items() if any(k in name for k in keys)]
        if sel:
            log(f"[profile] {what} kernels: {sum(v[0] for v in sel) / 1e3:.2f} ms in "
                f"{sum(v[1] for v in sel)} kernels, "
                f"{100 * sum(v[0] for v in sel) / 1e3 / busy_ms:.1f} % of the device's busy time")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"[profile] {us / 1e3:8.2f} ms {100 * us / 1e3 / busy_ms:5.1f} % {count:6d} x {name[:90]}")


def phase_train(cfg, device, card: str, timed_steps: int = 4, profile: bool = False,
                first_batch: dict | None = None) -> dict:
    """The training path; returns the launch counts of its checked steps and
    the timed steps' ms per step.  ``cfg`` decides whether the feed-forward
    blocks are the fused op; ``first_batch``, when given, is a loader batch
    that one more checked optimizer step takes before the synthetic ones."""
    import math

    import torch

    from transformertts_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    from transformertts_tpu_torch.data.prefetch import batch_to_device

    k, b = cfg.training.grad_acc_steps, cfg.training.batch_size
    ffn = cfg.runtime.use_pallas_fused_ffn
    tag = "train-ffn" if ffn else "train"
    model = train_model(cfg, device, seed=7)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, k, b) for _ in range(2)]
    before = {name: t.detach().clone() for name, t in model.state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    on_card = device.type == "cuda"

    checked = [batches[i % 2] for i in range(TRAIN_STEPS)]
    if first_batch is not None:
        if first_batch["melspec"].shape[:2] != (k, b):
            raise AssertionError(f"loader batch {first_batch['melspec'].shape}, wanted ({k}, {b}, ..)")
        checked.insert(0, batch_to_device(first_batch, device))
    zero_train_counters()
    for i, batch in enumerate(checked):
        state, metrics = step(state, batch, 0.8, gen)
        m = {name: float(v) for name, v in metrics.items()}
        if not (math.isfinite(m["total"]) and math.isfinite(m["grad_norm"])) or m["skipped"]:
            raise AssertionError(f"{tag} step {i}: {m}")
        log(f"[{tag}] step {i} on {tuple(batch['melspec'].shape)} mels: loss {m['total']:.4f} (pred {m['pred_mel']:.4f}, post "
            f"{m['post_mel']:.4f}, stop {m['stop']:.4f}), grad_norm {m['grad_norm']:.4f}")
    counts = train_counters()
    n_checked = len(checked)
    want = expected_train_launches(2 * k * n_checked, k * n_checked, ffn)
    if on_card and counts != want:
        raise AssertionError(f"{tag}: launches {counts}, the path implies {want}")
    if state.step != n_checked or state.opt_state["count"] != n_checked:
        raise AssertionError("the optimizer did not take every step")
    after = model.state_dict()
    same_w = [n for n, t in before.items() if t.ndim >= 2 and torch.equal(t, after[n])]
    same_bn = [n for n, t in before.items() if "running_" in n and torch.equal(t, after[n])]
    if same_w or same_bn:
        raise AssertionError(f"unchanged after {n_checked} steps: {same_w + same_bn}")

    # evaluation: the cross-attention returns its weights there (plain path by
    # design, as in the JAX package), so 6 flash and 15 LN forwards (and the 6
    # fused FFN forwards at dropout 0 when the flag is on)
    zero_train_counters()
    ev = make_eval_step(model, cfg)(state, {name: x[0] for name, x in batches[0].items()})
    ev = {name: float(v) for name, v in ev.items()}
    if not all(math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"eval step not finite: {ev}")
    want_eval = {"flash_fwd": 6, "flash_bwd": 0, "ln_fwd": LN_CALLS, "ln_bwd": 0,
                 "ffn_fwd": FFN_CALLS * ffn, "ffn_bwd": 0}
    if on_card and train_counters() != want_eval:
        raise AssertionError(f"eval: launches {train_counters()}, expected {want_eval}")
    log(f"[{tag}] eval step: loss {ev['total']:.4f}, mel_l1 {ev['mel_l1']:.4f}, mcd "
        f"{ev['mcd']:.3f}, diagonality {ev['diagonality']:.4f}")
    log(f"[{tag}] kernel launches over {n_checked} optimizer steps of {k} micro-batches: {counts}")

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
        log(f"[time] {tag} step (fused FFN {'on' if ffn else 'off'}, bf16, {k} x {b} rows, mel {MEL_BUCKET}, phonemes {PHON_BUCKET}, "
            f"double forward, dropout on): {step_ms:.1f} ms/step over {timed_steps} steps, "
            f"{audio_s / dt:.0f} audio-s/s ({audio_s / timed_steps:.0f} audio-s per step), peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if on_card and profile and timed_steps:
        profile_step(lambda: step(state, batches[0], 0.8, gen), step_ms, card)
    return {"launches": counts, "step_ms": step_ms}


N_CLIPS, N_VAL_CLIPS = 160, 16


def write_corpus(root, seed: int = 0) -> dict:
    """A seeded LJSpeech-shaped corpus under ``root``: ``wavs/<id>.wav``
    (mono, 16 bit, 22,050 Hz, 2-9 s) and ``metadata.csv``; the first ids fall
    in the validation split.  Returns {id: samples}."""
    rng = np.random.default_rng(seed)
    (root / "wavs").mkdir(parents=True)
    lengths, lines = {}, []
    for i in range(N_CLIPS):
        audio_id = f"LJ00{1 + i % 3}-{i:04d}" if i < N_VAL_CLIPS else f"LJ0{10 + i % 40}-{i:04d}"
        n = int(rng.integers(2 * AUDIO["sample_rate"], 9 * AUDIO["sample_rate"]))
        y = clip_signal(rng, n)
        with wave.open(str(root / "wavs" / f"{audio_id}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(AUDIO["sample_rate"])
            w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())
        lengths[audio_id] = n
        text = TEXTS[i % len(TEXTS)]
        lines.append(f"{audio_id}|{text}|{text}")
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    return lengths


def phase_preprocess(cfg, device, root) -> dict:
    """The preprocessing path on the card; returns the log-mel kernel's
    launch count and the directory it wrote."""
    import dataclasses

    from transformertts_tpu_torch.data import load_stats
    from transformertts_tpu_torch.data.audio_io import load_wav
    from transformertts_tpu_torch.data.preprocess import _DEVICE_MEL_BATCH, preprocess
    from transformertts_tpu_torch.dsp import mel_spectrogram_np, normalize_mel
    from transformertts_tpu_torch.ops.stft import log_mel

    t0 = time.perf_counter()
    lengths = write_corpus(root / "LJSpeech-1.1")
    t_write = time.perf_counter() - t0
    out = root / "preprocessed"
    pcfg = cfg.replace(
        path=dataclasses.replace(cfg.path, data=str(root / "LJSpeech-1.1"), preprocessed=str(out)),
        runtime=dataclasses.replace(cfg.runtime, use_pallas_mel=True))
    log_mel.launches = 0
    t0 = time.perf_counter()
    preprocess(pcfg, device=device)
    t_prep = time.perf_counter() - t0
    launches = log_mel.launches
    chunks = -(-N_CLIPS // _DEVICE_MEL_BATCH)
    # the statistics pass and the saving pass both extract
    if device.type == "cuda" and launches != 2 * chunks:
        raise AssertionError(f"preprocess: {launches} log-mel launches, expected {2 * chunks}")
    files = sorted(out.glob("*.npz"))
    if [p.stem for p in files] != sorted(lengths):
        raise AssertionError(f"preprocess wrote {len(files)} npz files for {N_CLIPS} clips")
    stats = load_stats(out)
    if not (np.isfinite(stats["mean"]) and stats["std"] > 0):
        raise AssertionError(f"bad stats.json: {stats}")
    hop, worst_max, worst_mean, frames = AUDIO["hop_length"], 0.0, 0.0, 0
    for path in files:
        with np.load(path, allow_pickle=True) as z:
            if set(z.files) != {"melspec", "transcript", "phoneme", "sequence"}:
                raise AssertionError(f"{path.name}: keys {z.files}")
            mel, seq = z["melspec"], z["sequence"]
        n = lengths[path.stem]
        if mel.shape != (AUDIO["n_mels"], 1 + n // hop) or mel.dtype != np.float32:
            raise AssertionError(f"{path.name}: mel {mel.shape} for {n} samples")
        if seq.dtype != np.int32 or len(seq) == 0 or not np.isfinite(mel).all():
            raise AssertionError(f"{path.name}: bad sequence or mel values")
        y, _ = load_wav(root / "LJSpeech-1.1" / "wavs" / f"{path.stem}.wav", AUDIO["sample_rate"])
        ref = normalize_mel(mel_spectrogram_np(y, **AUDIO), stats["mean"], stats["std"])
        diff = np.abs(mel - ref) * (stats["std"] + 1e-8)  # back on the log-mel's own scale
        worst_max, worst_mean = max(worst_max, float(diff.max())), max(worst_mean, float(diff.mean()))
        frames += mel.shape[1]
    if not (worst_max <= MEL_TOL_NP[0] and worst_mean <= MEL_TOL_NP[1]):
        raise AssertionError(f"preprocess != numpy FFT: max {worst_max:.3g}, mean {worst_mean:.3g}")
    audio_s = sum(lengths.values()) / AUDIO["sample_rate"]
    log(f"[preprocess] {N_CLIPS} clips, {audio_s:.0f} audio-s, {frames} frames: corpus written in "
        f"{t_write:.1f} s, preprocess (two passes, g2p, npz) {t_prep:.1f} s = "
        f"{audio_s / t_prep:.0f} audio-s/s; {launches} log-mel launches for {chunks} chunks of "
        f"{_DEVICE_MEL_BATCH}; stats mean {stats['mean']:.4f} std {stats['std']:.4f}; vs numpy FFT "
        f"max {worst_max:.2e} mean {worst_mean:.2e}")
    return {"launches": launches, "dir": out}


def loader_batch(cfg, prep_dir) -> dict:
    """One (K, B, ...) batch of the port's bucketed loader over what the
    preprocess phase wrote, read through ``prefetch``."""
    from transformertts_tpu_torch.data import BucketedLoader, LJSpeechDataset
    from transformertts_tpu_torch.data.prefetch import prefetch

    ds = LJSpeechDataset(prep_dir, "train")
    val = LJSpeechDataset(prep_dir, "val")
    if (len(ds), len(val)) != (N_CLIPS - N_VAL_CLIPS, N_VAL_CLIPS):
        raise AssertionError(f"split {len(ds)} / {len(val)}")
    loader = BucketedLoader(
        ds, cfg.training.batch_size, cfg.runtime.phoneme_buckets, cfg.runtime.mel_buckets,
        n_mels=cfg.model.n_mels, grad_acc_steps=cfg.training.grad_acc_steps, shuffle=True,
        drop_last=False, seed=cfg.training.seed)
    # the fullest batch of the epoch: 144 clips spread over many buckets, so
    # most groups are partial (repeat-padded rows, masked by a length of 0)
    n_real = lambda b: int((b["melspec_lens"] > 0).sum())  # noqa: E731
    batch = max(prefetch(loader.epoch(0)), key=n_real)
    real = n_real(batch)
    log(f"[train-ffn] loader: {len(ds)} train clips in {len(loader.buckets)} buckets, "
        f"{loader.batches_per_epoch()} batches per epoch; fullest batch phonemes "
        f"{batch['phoneme'].shape}, mels {batch['melspec'].shape}, {real} real rows")
    return batch


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
        # dropout off: the share of the mask hash in the kernels' time
        args0 = (dh ** -0.5, causal, 0.0, args[3])
        out0, m0, l0 = fa.flash_forward(q, k, v, bias, 99, *args0)
        fwd0 = device_ms(lambda: fa.flash_forward(q, k, v, bias, 99, *args0))
        bwd0 = device_ms(lambda: fa.flash_backward(q, k, v, bias, 99, out0, dout, m0, l0, *args0))
        host_f = host_us(lambda: fa.flash_forward(q, k, v, bias, 99, *args))
        host_b = host_us(lambda: fa.flash_backward(q, k, v, bias, 99, out, dout, m, l, *args))
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
        log(f"[time] bf16 flash {name} at p=0: forward {fwd0 * 1e3:.1f} us, backward "
            f"{bwd0 * 1e3:.1f} us (the mask hash: {100 * (1 - fwd0 / fwd):.0f} % / "
            f"{100 * (1 - bwd0 / bwd):.0f} % of the p={p} times); host per eager call: "
            f"flash_forward {host_f:.1f} us, flash_backward {host_b:.1f} us [{card}]")

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

        def k_bwd(p_=p):
            x, hh, g, _, dy = nxt()
            return ln.fused_ln_backward(x, hh, g, dy, 99, p_, 1e-5, rows_m)

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
        bwd = device_ms(k_bwd)
        report("ln_bwd", name, bwd, time_ms(p_bwd, 5, 2), b_bound, b_by, lib_bwd, shape)
        bwd0 = device_ms(lambda: k_bwd(0.0))
        log(f"[time] bf16 ln_bwd {name} at p=0: {bwd0 * 1e3:.1f} us (the mask hash: "
            f"{100 * (1 - bwd0 / bwd):.0f} % of the p={p} time) [{card}]")
    return rows


def phase_time_ffn_mel(device, card: str) -> dict:
    """Rows 7-9 at their paths' shapes: the FFN kernels in bf16 at dropout
    0.1 beside ``F.linear -> relu -> F.linear`` (dropout 0, bf16 weights; its
    backward through autograd), the log-mel kernel at the batch preprocess
    sends.  Kernel and library as device time per call (CUDA-graph replay),
    the plain versions between events around eager calls."""
    import torch
    import torch.nn.functional as F

    from transformertts_tpu_torch.dsp import mel_filterbank
    from transformertts_tpu_torch.ops import fused_ffn as ffn
    from transformertts_tpu_torch.ops import stft

    dtype, p, es, d, f = torch.bfloat16, 0.1, 2, TRAIN_D, TRAIN_F
    rows = {}

    def report(kernel, shape, ms, plain, bound, by, lib, note):
        rows[(kernel, shape)] = (ms, plain, bound, by, lib)
        lib_txt = "none" if lib is None else f"{lib * 1e3:.1f} us"
        log(f"[time] {kernel} {shape} {note}: kernel {ms * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by}), library {lib_txt} [{card}]")

    for name, n in FFN_ROWS.items():
        x, w1, b1, w2, b2, dy = ffn_inputs(n, d, f, dtype, device, seed=n)
        rows_m = ffn.pick_rows(n, d, f, es)
        args = (99, p, rows_m)
        lw1, lb1, lw2, lb2 = (t.to(dtype).requires_grad_(True) for t in (w1, b1, w2, b2))
        lx = x.detach().requires_grad_(True)

        def lib_fwd(x_=lx):
            return F.linear(torch.relu(F.linear(x_, lw1, lb1)), lw2, lb2)

        with torch.no_grad():
            lib_f = device_ms(lambda: lib_fwd(x))
        lib_b = device_ms(
            lambda ly: torch.autograd.grad(ly, (lx, lw1, lb1, lw2, lb2), dy, retain_graph=True),
            setup=lib_fwd)
        w_bytes = 2 * d * f * 4  # the fp32 parameters as they lie
        f_bound, f_by = bound_ms(2 * n * d * es + w_bytes + (f + d) * 4, 4 * n * d * f,
                                 PEAK_BF16_FLOPS)
        b_bound, b_by = bound_ms(3 * n * d * es + w_bytes + f * 4 + (2 * d * f + f + d) * 4,
                                 10 * n * d * f, PEAK_BF16_FLOPS)
        shape = f"N={n} D={d} F={f} bf16 p={p}"
        report("ffn_fwd", name,
               device_ms(lambda: ffn.fused_ffn_forward(x, w1, b1, w2, b2, *args), n=10, reps=5),
               time_ms(lambda: ffn.fused_ffn_reference(x, w1, b1, w2, b2, *args), 5, 2),
               f_bound, f_by, lib_f, shape)
        bwd = device_ms(lambda: ffn.fused_ffn_backward(x, w1, b1, w2, dy, *args), n=5, reps=5)
        report("ffn_bwd", name, bwd,
               time_ms(lambda: ffn.fused_ffn_backward_reference(x, w1, b1, w2, dy, *args), 5, 2),
               b_bound, b_by, lib_b, shape)
        bwd0 = device_ms(lambda: ffn.fused_ffn_backward(x, w1, b1, w2, dy, 99, 0.0, rows_m),
                         n=5, reps=5)
        log(f"[time] ffn_bwd {name} at p=0: {bwd0 * 1e3:.1f} us (the mask hash: "
            f"{100 * (1 - bwd0 / bwd):.0f} % of the p={p} time) [{card}]")

    # row 9: the batch preprocess sends (32 clips in one 163,840-sample bucket)
    rng = np.random.default_rng(9)
    clips = [clip_signal(rng, int(n)) for n in rng.integers(44100, MEL_BUCKET_LEN - 1024, MEL_BATCH)]
    y = torch.from_numpy(padded_batch(clips, MEL_BUCKET_LEN)).to(device)
    a = AUDIO
    consts = stft._constants(a["sample_rate"], a["n_fft"], a["win_length"], a["n_mels"],
                             a["fmin"], a["fmax"], device)
    n_fft, hop, n_bins = a["n_fft"], a["hop_length"], 1 + a["n_fft"] // 2
    n_frames = 1 + (MEL_BUCKET_LEN - n_fft) // hop
    frames = MEL_BATCH * n_frames
    basis = mel_filterbank(a["sample_rate"], n_fft, a["n_mels"], a["fmin"], a["fmax"])
    # what the function needs, not what this kernel does: the signal, the
    # window and the filterbank read once and the log-mels written once (the
    # DFT matrices are this kernel's own device, no input of the function);
    # per frame the window, a real FFT (2.5 n log2 n operations, the usual
    # count, where the kernel's two dense products do 4 n_fft n_bins), the
    # magnitudes, and the filterbank's non-zero weights
    nbytes = (y.numel() + n_fft + basis.size + frames * a["n_mels"]) * 4
    flops = frames * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_bins
                      + 2 * int(np.count_nonzero(basis)))
    dense_flops = frames * (4 * n_fft * n_bins + 3 * n_bins
                            + 2 * int(np.count_nonzero(basis)))
    bound, by = bound_ms(nbytes, flops, PEAK_FP32_FLOPS)
    log(f"[time] log_mel batch: {nbytes / 1e6:.1f} MB and {flops / 1e9:.2f} GFLOP by an FFT; "
        f"the kernel's dense DFT products do {dense_flops / 1e9:.1f} GFLOP, "
        f"{dense_flops / PEAK_FP32_FLOPS * 1e6:.0f} us at the fp32 peak")
    report("log_mel", "batch",
           device_ms(lambda: stft.log_mel_forward(y, n_frames, *consts, hop), n=4, reps=3),
           time_ms(lambda: stft.log_mel_reference(y, n_frames, *consts, hop), 3, 1),
           bound, by, None, f"B={MEL_BATCH} n={MEL_BUCKET_LEN} center=False fp32, {frames} frames")
    # no single PyTorch call computes the log-mel; this chain of library calls
    # (cuFFT, a matrix product, two elementwise ops) is printed for scale only
    window, melt = consts[0], consts[3]
    chain = device_ms(lambda: torch.log(torch.clamp(
        torch.stft(y, n_fft, hop, n_fft, window, center=False, return_complex=True).abs()
        .transpose(1, 2) @ melt, min=stft.CLIP)), n=4, reps=3)
    log(f"[time] log_mel batch: the chain torch.stft().abs() -> matmul -> clamp -> log takes "
        f"{chain * 1e3:.1f} us [{card}]")
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
    if "train-ffn" in phases and "preprocess" not in phases:
        ap.error("train-ffn reads what the preprocess phase wrote: name both")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 1
    import dataclasses
    from pathlib import Path

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
    if "kernel" in phases:
        train_worst.update(phase_ffn_kernels(device))
    mel_worst = phase_mel_kernel(device) if "kernel" in phases else {}
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
        phase_train_parity(with_fused_ffn(cfg), device, batch_seed=12)
    train, train_ffn, prep = {}, {}, {}
    timed = 4 if "time-train" in phases else 0
    if "train" in phases:
        train = phase_train(cfg, device, card, timed_steps=timed, profile=args.profile)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if "preprocess" in phases:
            prep = phase_preprocess(cfg, device, Path(tmp))
        if "train-ffn" in phases:
            train_ffn = phase_train(
                with_fused_ffn(cfg), device, card, timed_steps=timed, profile=args.profile,
                first_batch=loader_batch(cfg, prep["dir"]))
    if train and train_ffn and timed:
        log(f"[time] train step, fused FFN off / on: {train['step_ms']:.1f} / "
            f"{train_ffn['step_ms']:.1f} ms [{card}]")
    train_rows = phase_time_train(device, card) if "time-train" in phases else {}
    if "time-train" in phases:
        train_rows.update(phase_time_ffn_mel(device, card))
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    if phases != set(ALL_PHASES):
        log(f"[partial] phases {sorted(phases)} passed; no result for a partial run")
        return 0
    src = "transformertts_tpu_torch/ops/csrc/"
    pallas = "transformertts_tpu/ops/pallas/"
    kernels = []
    for b, name, line, key in ((1, "decode_step", 300, "b1"),
                               (8, "decode_step_batched", 532, "batched")):
        ms, plain, bound, by = rows[("Config()", b, SERVE_MAX_LEN, 64, 200)]
        kernels.append({
            "name": f"{name} (B={b}, bf16, n_pos {SERVE_MAX_LEN}, Tp 64, t 200)",
            "route": "cuda", "source": src + "decode_step.cu",
            "replaces": f"{pallas}decode_step.py:{line}",
            "launches": launches[key], "max_abs_err": worst[b],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
            "shapes": {f"{what} n_pos {n_pos} Tp {tp} t {t}": dict(
                zip(("ms", "plain_ms", "bound_ms", "bound_by"), r))
                for (what, rb, n_pos, tp, t), r in rows.items() if rb == b},
        })
    # rows 3-9: the record's numbers are those of the largest shape on the
    # path; "shapes" holds every shape of the path
    for kernel, source, site, count, err, main_shape, what in (
            ("flash_fwd", "flash_attention.cu", "flash_attention.py:167", "flash_fwd",
             ("flash", "fwd"), "dec_self", "B=16 H=4 (768,768) D=64 causal, bf16, p=0.1"),
            ("flash_bwd", "flash_attention.cu", "flash_attention.py:292", "flash_bwd",
             ("flash", "bwd"), "dec_self", "B=16 H=4 (768,768) D=64 causal, bf16, p=0.1"),
            ("ln_fwd", "fused_ln.cu", "fused_ln.py:142", "ln_fwd", ("ln", "fwd"), "decoder",
             "N=12288 D=256, bf16, p=0.1"),
            ("ln_bwd", "fused_ln.cu", "fused_ln.py:178", "ln_bwd", ("ln", "bwd"), "decoder",
             "N=12288 D=256, bf16, p=0.1"),
            ("ffn_fwd", "fused_ffn.cu", "fused_ffn.py:184", "ffn_fwd", ("ffn", "fwd"), "decoder",
             "N=12288 D=256 F=1024, bf16, p=0.1"),
            ("ffn_bwd", "fused_ffn.cu", "fused_ffn.py:236", "ffn_bwd", ("ffn", "bwd"), "decoder",
             "N=12288 D=256 F=1024, bf16, p=0.1"),
            ("log_mel", "log_mel.cu", "stft.py:104", None, None, "batch",
             "B=32 n=163840 center=False, fp32")):
        ms, plain, bound, by, lib = train_rows[(kernel, main_shape)]
        if kernel == "log_mel":  # launched on the preprocessing path
            n_launches, max_err = prep["launches"], max(mel_worst.values())
        else:  # rows 3-6 on the training path, rows 7-8 on its fused-FFN configuration
            n_launches = (train_ffn if kernel.startswith("ffn") else train)["launches"][count]
            max_err = train_worst[err]
        kernels.append({
            "name": f"{kernel} ({what})", "route": "cuda", "source": src + source,
            "replaces": pallas + site, "launches": n_launches,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
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
