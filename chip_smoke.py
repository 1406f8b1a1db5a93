#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--phases build,kernel,...] [--profile]

Phases, each of which fails the run (non-zero exit) when it fails:

1. build: the CUDA kernels of ``transformertts_tpu_torch/ops/csrc`` with
   nvcc, one process per source, all at once; for the decode-step (without
   and with prenet dropout, and its verify form), flash,
   fused-FFN, fused-LN and log-mel libraries each kernel's registers and
   spills, ptxas's warnings of serialized wgmma (one on the bf16 FFN forward
   fails the run), the dynamic shared memory at the path shapes (the decode
   step at ``Config()`` and ``paper.yaml`` widths; the bf16 FFN forward's
   and the log-mel FFT kernel's plans against the libraries' own sizes), the
   HGMMA (wgmma) instructions in the SASS (where cuobjdump exists; the
   tensor-core kernels must hold some) and the bf16 FFN forward's SASS
   instructions per intermediate element; the rate-0 decode-step kernels'
   registers and spills must equal ``DECODE_STEP_PTXAS`` and the verify
   kernels' ``DECODE_VERIFY_PTXAS``; the verify kernels' HMMA (mma.sync)
   instructions are counted: every bf16 one must hold some, no fp32 one;
2. mask: the device ``keep_mask`` against its plain version, bit for bit;
3. kernel: every kernel against its plain PyTorch version on the card.
   The decode-step kernel (``decode_step_reference``) at the full width of
   ``Config()`` (d_model 256, 3 layers, 4 heads, d_ffn 1024, 80 mels): B in
   {1, 8}, t in {0, 1, 700} with 1,500 cache positions and 192 encoder
   positions, the expected-position output off and on, bf16 and fp32, plus
   the serving shape (400 positions, 64 encoder positions); and at
   ``configs/paper.yaml`` widths (d_model 512, 6 layers, 8 heads, d_ffn
   2,048): B in {1, 8}, t in {0, 700, 1,499}, the same positions, output
   and dtypes; and with inference prenet dropout 0.5 (a seed and a first
   row of 3) at ``Config()``, B in {1, 8}, t in {0, 700}, bf16 and fp32.
   Each case is called twice for equal bits, and one call (also one with
   prenet dropout, and one verify pass of speculative decode) under
   ``torch.profiler`` must be exactly one kernel launch.  The flash
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
   each forward and backward twice for equal bits (bf16 forwards on the
   tensor-core kernel, fp32 on the CUDA-core one).  The log-mel FFT kernel
   at one clip (``center=True``, a length that is no multiple of the hop),
   at a batch of 32 rows of 163,840 samples (``center=False``, as
   ``preprocess`` sends them), at lengths that rule out 16-byte loads and at
   n_fft 512 and 2,048, and the dense kernel at n_fft 800 with a window of
   640, each against its plain version and against ``mel_spectrogram_np``,
   and each call checked to have launched the kernel its n_fft selects;
4. decode: the full decode through the kernel loop against the plain loop,
   fp32 weights, B = 2 with ragged lengths, 64 forced frames, W = 0 and 2,
   without and with inference prenet dropout 0.5 (the same hash masks);
   at ``configs/large_tp.yaml`` widths the kernel decode in fp32 against
   ``naive_decode`` and the step in bf16 against its plain version (B 1
   and 8, t 0, 200, 399, within ``TOL``, equal bits); then the stop votes
   read back ``LAG`` steps late (``check_late_readback``) at ``Config()``,
   bf16, B 8, 576 forced steps;
5. serve: the serving path, ``make_http_server`` -> ``DynamicBatcher`` ->
   ``Synthesizer`` -> kernel loop, with seeded random weights in bf16:
   13 HTTP requests (12 concurrent, then one alone), one batch at the
   default stop threshold and one batch of 12 rows (decoded as kernel
   calls of 8 and 4 rows); the kernel's launch counts are zeroed before
   and read after, and must equal the decode steps run;
6. stream: streaming synthesis at ``Config()`` and at
   ``configs/fast_serve.yaml`` (reduction factor 2), seeded random weights
   in bf16, max_len 512, chunk 64, stop threshold 2.0: one text through
   ``stream_decode`` (its pre-postnet frames equal to the one-shot kernel
   decode's bit for bit, its postnet frames within ``TOL`` of bf16: the
   postnet runs in bf16 on windows; one launch a step), ten texts (row chunks of 8 and 2 rows in lockstep, each
   chunk's launches equal to its steps), ``Synthesizer.stream`` timed (time
   to the first chunk, time per later chunk, frames/s beside
   ``Synthesizer.synthesize`` of the same text); then two lines through
   ``cli serve --wav`` on a checkpoint the phase writes with the port's
   ``CheckpointManager``, and ``entry()``'s forward once (its shapes);
7. spec: speculative decode (``runtime.decode_speculative_k``) on the
   verify form of the decode-step kernel.  The verify kernel against its
   plain version (``verify_pass_reference``) at ``Config()`` widths, K in
   {2, 4, 8}, and ``paper.yaml`` widths, K = 4: 400 cache positions and 64
   encoder positions, t in {0, 200, 400 - K}, bf16 and fp32, every draft
   accepted (tau 1e9) and tau 0.5 with stop threshold 0.5; outputs within
   ``TOL``, the acceptance equal to ``accept_reference``'s on the kernel's
   own outputs, only the accepted frames and the K/V rows t .. t + K - 1
   written, equal bits from a second call, one launch counted a call (the
   kernel phase profiles one pass: one kernel, the verify form).  Whole
   decodes at B = 1, fp32, 64 forced frames: tau 0 against the sequential
   kernel decode (one pass a group), tau 1e9 in ceil(64 / K) passes at K =
   4 and 3, the kernel loop against the plain chunk loop.  Then the user's
   path with K = 4 (counts from 0): ``Synthesizer.synthesize`` of one text
   (bf16, 400 frames) and ``cli synthesize --set
   runtime.decode_speculative_k=4`` on a checkpoint the phase writes; every
   pass one verify launch and no decode-step launch; a two-text batch falls
   through to the decode-step kernel;
8. train-parity: one micro-batch of 16 rows at full width in fp32, dropout
   and scheduled sampling on, once through the kernels and once through
   their plain versions from the same generator seeds (so both drop the
   same elements): the loss and every parameter's gradient are compared;
   then a second micro-batch the same way with
   ``runtime.use_pallas_fused_ffn`` on;
9. train: the training path, ``create_train_state`` + ``make_train_step``
   at ``Config()`` (bf16, 4 micro-batches of 16 rows, 768 mel frames, 128
   phonemes, double forward, dropout on) for 3 optimizer steps on seeded
   synthetic batches, then one ``make_eval_step``; the kernels' launch
   counts are zeroed before and read after, and must be what the path
   implies (per step 72 / 36 flash and 120 / 60 LayerNorm forwards /
   backwards), fused FFN off as by default;
10. preprocess: the preprocessing path.  A seeded corpus of 160 mono 16-bit
   wavs of 2-9 s at 22,050 Hz (moving sines and noise; ids in both splits)
   with a ``metadata.csv`` is written into a temporary directory, the
   port's ``preprocess`` runs on it with ``runtime.use_pallas_mel`` on the
   card, and the npz keys, ``stats.json``, every clip's frame count and
   every mel (against ``mel_spectrogram_np`` under the same statistics) are
   checked; the log-mel kernels' launch counts are zeroed before, and after
   the FFT kernel's must be twice the number of 32-clip chunks and the dense
   kernel's 0;
11. train-ffn: the training path with ``runtime.use_pallas_fused_ffn`` on.
   The first optimizer step takes a batch that ``BucketedLoader`` over
   ``LJSpeechDataset`` (through ``prefetch``) reads from what the
   preprocess phase wrote, then 3 checked and 4 timed steps on the
   synthetic batches of the train phase, then one evaluation step; per
   optimizer step 48 / 24 FFN forwards / backwards beside the 72 / 36
   flash and 120 / 60 LayerNorm ones;
12. trainer: the user's path preprocess -> train -> checkpoint -> wav.  A
    seeded corpus of 208 clips of 8.3-8.9 s whose texts are 97-128 phonemes
    long (every item in bucket (128, 768); 16 in the val split) is
    preprocessed on the log-mel kernel; one epoch of its train split is
    read by the numpy reader and by the native npz reader (the C++ library
    of ``transformertts_tpu_torch/native``, built here with the host
    compiler) in turns, numpy / native / native / numpy, with equal bytes
    and each read's time per batch printed; ``Trainer.fit`` trains ``Config()``
    (bf16, full width and depth, 16 x 4 rows, EMA 0.99) for 2 epochs of 3
    optimizer steps, the second with scheduled sampling, each validated
    teacher-forced and free-running (batched decode-step kernel, 4 rows of
    800 frames: the stop threshold is set above 1).  It fails unless flash
    and LN forward and backward and the decode step launched during
    ``fit`` and every training and validation batch of ``fit`` and of the
    resumed run was read by the native reader; the last validation decode equals,
    bit for bit, the decode of a fresh model restored from the latest
    checkpoint's eval params; every restored tensor equals the saved one;
    ``Trainer(resume=True)`` with 3 epochs starts at epoch 2 and adds one
    history row; and ``cli synthesize --wav`` writes 800 frames' wav through
    the B = 1 kernel.  It prints per epoch the audio-s/s, the median ms per
    optimizer step, the share of the epoch blocked on the loader, the
    validation and checkpoint times, and the restore time;
13. parallel: data, tensor and sequence parallelism (``parallel/``).
    ``configs/large_tp.yaml`` at full width (d_model 1,024, 16 heads, d_ffn
    4,096, 6 + 6 layers), seeded weights, bf16, one micro-batch of 16 rows
    at 768 frames, dropout, scheduled sampling and guided attention on: one
    optimizer step in one process, then the same step in two processes on
    the one card at (1 data x 2 model) with sequence parallelism (gloo with
    CUDA tensors: NCCL refuses two ranks on one device); the loss, grad norm,
    every gradient (Adam's first moment) and every parameter after the step
    within bf16's ``TRAIN_TOL``, and the flash and LN launch counts of each
    rank what the path implies (8 heads, 6,144 decoder rows a rank); each
    step's ms per step (2 timed steps); then ``entry.dryrun_multichip`` over
    NCCL on every card, and rows 3-8 at PERF.md's shapes at offset 0 and at
    a shard's mask offsets, in turns;
14. time: the decode-step kernel beside its plain version and its bound
    at ``Config()`` and ``paper.yaml`` widths, with the host's time per eager
    call and the kernel's time by stage (its global-timer stamps), at the
    serving shape also with prenet dropout 0.5, and decode frames/s through
    ``Synthesizer.synthesize``; the verify kernel's device time per pass and
    by stage (bf16 K 2, 4, 8 and fp32 K 4; bf16 K 4 at ``paper.yaml``)
    beside the step's, its plain version's and its bound, and
    ``Synthesizer.synthesize``'s frames/s at B = 1 with K = 4 at tau 0, 1e9
    and the default between two sequential runs;
15. time-train: every training and preprocessing kernel beside its plain
    version, its bound and (where PyTorch has a call or a short chain of
    calls for the same function) that (flash, the LN and the FFN kernels
    also at dropout 0, and flash's host time per eager call; the FFN forward
    also at ``paper.yaml`` widths; the log-mel FFT kernel beside the dense
    one and the operations each does), and both training configurations' ms
    per step and audio-seconds per second; all timings with the card's name
    and power limit;
16. tacotron2 (run after the decode phase): the Tacotron 2 step kernel
    (``ops/tacotron2_step.py``) at NVIDIA's widths
    (``portbench/configs/tacotron2.json``, seeded weights, bf16), B 1 and
    8 over Tp 192 with prenet dropout 0.5: 32 steps of the
    kernel and of ``tacotron2_step_reference``, each from its own state and
    both fed the kernel's frames, every stage's output and state within
    ``T2_TOL`` at every step; a second run of the kernel equal bit for bit;
    64 calls under ``torch.profiler`` no other kernel and at most 64
    launches; the kernel's time a step back to back beside its plain
    version's and its bound (``portbench/counts_tacotron2.py``); then the
    main path: 12 concurrent requests of 576 frames through
    ``DynamicBatcher`` -> ``Synthesizer`` and one ``Synthesizer.stream``,
    ``Tacotron2Step.total`` zeroed before each: one launch a decode step;
    then the stop votes read back ``LAG`` steps late (``check_late_readback``)
    at B 8, 576 forced steps.

``check_late_readback`` (phases decode and tacotron2): a B 8 decode of 576
forced steps under ``torch.profiler`` waits on the device (CUDA's
``cudaEventSynchronize`` and ``cudaStreamSynchronize`` calls) at most
ceil(576 / ``LAG``) + 2 times, launches the step kernel once a step (the
wrapper's counter) and gives frames bit-equal to a run that reads the votes
after every step (``LAG`` 1); the loop's ms a step of both, in turns (1,
``LAG``, ``LAG``, 1); then a decode whose rows vote (the stop threshold
taken from the forced run's stop logits, the batch's stop by step 288)
equal bit for bit at both lags, its overrun rolled back.

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
ALL_PHASES = ("build", "mask", "kernel", "decode", "serve", "stream", "spec", "train-parity",
              "train", "preprocess", "train-ffn", "trainer", "parallel", "time", "time-train",
              "tacotron2")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max|kernel - plain| / max(1, max|plain|)
# kernel loop vs plain loop, fp32, 64 fed-back frames: as the CPU test of the
# port against the JAX loop; the H100 showed at most 1.2e-6 relative
DECODE_TOL = 1e-4
SERVE_MAX_LEN = 400
STREAM_MAX_LEN, STREAM_CHUNK = 512, 64
PRENET_DROPOUT = 0.5
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


def fast_serve_config():
    """``configs/fast_serve.yaml``: ``Config()``'s widths at reduction factor 2."""
    from pathlib import Path

    from transformertts_tpu_torch.config import load_config

    return load_config(Path(__file__).resolve().parent / "configs" / "fast_serve.yaml")


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
    for name in ("decode_step", "decode_step_dropout", "decode_step_verify", "flash_attention",
                 "fused_ffn", "fused_ln", "log_mel"):
        kernel_report(name, libs[name])
    check_step_ptxas(libs["decode_step"])
    check_verify_ptxas(libs["decode_step_verify"])


# The rate-0 decode-step library's kernels, by (type, rows), as they were
# built before the verify form shared their source: registers and ptxas's
# spill line.  The verify form (and any later option) must leave them so.
DECODE_STEP_PTXAS = {
    ("__nv_bfloat16", 8): (128, "32 bytes stack frame, 64 bytes spill stores, 148 bytes spill loads"),
    ("__nv_bfloat16", 7): (128, "24 bytes stack frame, 60 bytes spill stores, 156 bytes spill loads"),
    ("__nv_bfloat16", 6): (128, "24 bytes stack frame, 32 bytes spill stores, 104 bytes spill loads"),
    ("__nv_bfloat16", 5): (128, "8 bytes stack frame, 8 bytes spill stores, 64 bytes spill loads"),
    ("__nv_bfloat16", 4): (128, "8 bytes stack frame, 8 bytes spill stores, 56 bytes spill loads"),
    ("__nv_bfloat16", 3): (128, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("__nv_bfloat16", 2): (126, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("__nv_bfloat16", 1): (118, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 8): (128, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 7): (126, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 6): (122, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 5): (115, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 4): (112, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 3): (110, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 2): (104, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 1): (96, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
}


# The verify library's kernels (decode_step_verify.cu), by (type, rows K):
# registers and ptxas's spill line as first built (none spills).
DECODE_VERIFY_PTXAS = {
    ("float", 8): (127, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 7): (119, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 6): (119, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 5): (115, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 4): (107, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 3): (112, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("float", 2): (101, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("__nv_bfloat16", 8): (113, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("__nv_bfloat16", 7): (95, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("__nv_bfloat16", 6): (115, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("__nv_bfloat16", 5): (121, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("__nv_bfloat16", 4): (117, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("__nv_bfloat16", 3): (96, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("__nv_bfloat16", 2): (96, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
}


def check_step_ptxas(path) -> None:
    """The rate-0 decode-step kernels' registers and spills equal
    ``DECODE_STEP_PTXAS``, kernel by kernel."""
    check_ptxas(path, "decode_step", DECODE_STEP_PTXAS, "rate-0 kernels")


def check_verify_ptxas(path) -> None:
    """The verify kernels' registers and spills equal
    ``DECODE_VERIFY_PTXAS``, kernel by kernel (none spills)."""
    check_ptxas(path, "decode_verify", DECODE_VERIFY_PTXAS, "verify kernels")


def check_ptxas(path, kernel: str, want: dict, what: str) -> None:
    """Registers and ptxas's spill line of every ``<kernel>_kernel<type,
    rows>`` of a library's report equal ``want``'s."""
    import re

    rows = ptxas_kernels(path.with_suffix(".log").read_text())
    got = {}
    for short, (_, regs, spill) in zip(demangle([r[0] for r in rows]), rows):
        found = re.search(rf"{kernel}_kernel<([\w ]+), (\d+)", short)
        if found is None:
            raise AssertionError(f"{kernel}: an unexpected kernel {short}")
        got[(found.group(1), int(found.group(2)))] = (regs, spill)
    if got != want:
        diff = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
        raise AssertionError(f"{kernel}: registers or spills moved (now, before): {diff}")
    log(f"[build] {kernel}: the {len(got)} {what} keep their registers and spills")


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
    out = [o.replace("(anonymous namespace)::", "") for o in out]
    found = [re.search(r"\b(\w+(?:<[^()]*>)?)\(", o) for o in out]
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
        out = [f"D={TRAIN_D}: fp32 forward {smem[0]}, bf16 backward dh {smem[1]}, "
               f"gradients {smem[2]} bytes"]
        # the bf16 forward: the plan's sizes against the library's own
        for n, d, f in ((FFN_ROWS["decoder"], TRAIN_D, TRAIN_F), (FFN_ROWS["encoder"], TRAIN_D, TRAIN_F),
                        (1000, 512, 2048), (264, 1024, 4096)):
            pl = ffn.fwd_plan(n, d, f)
            lib = (ctypes.c_longlong * 2)()
            if ffn._lib().tts_fused_ffn_fwd_tc_bytes(d, f, pl["stages"], lib) != 0:
                raise AssertionError(f"tts_fused_ffn_fwd_tc_bytes refused D = {d}")
            if (lib[0], lib[1]) != (pl["smem"], pl["staged_bytes"]):
                raise AssertionError(f"fwd_plan {pl['smem']}, {pl['staged_bytes']} != library "
                                     f"{lib[0]}, {lib[1]} bytes at D = {d}, F = {f}")
            out.append(f"bf16 forward N={n} D={d} F={f}: {pl['smem']} bytes ({pl['stages']} ring "
                       f"stages of d_ffn slices of {pl['s']}), grid {pl['grid']} of "
                       f"{pl['threads']} threads, clusters of {pl['fsplit']}, staged weights "
                       f"{pl['staged_bytes']} bytes")
        return out
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
    if name == "decode_step_verify":
        from transformertts_tpu_torch.ops.decode_step import verify_plan

        out = []
        for what, cfg, ks in (("Config()", default_config(), (2, SPEC_K, 8)),
                              ("paper.yaml", paper_config(), (SPEC_K,))):
            m = cfg.model
            r = m.reduction_factor
            for itemsize, dtype in ((2, "bfloat16"), (4, "float32")):
                for k in ks:
                    _, pieces, lay = verify_plan(
                        m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels,
                        m.n_mels * r + r, k, r, m.decoder_n_head, SERVE_MAX_LEN + k, 64, itemsize)
                    real = pieces[:, :, 3] < (1 << 30)
                    out.append(f"{what} {dtype} K={k}, n_pos {SERVE_MAX_LEN}, Tp 64: one cluster "
                               f"of 16 blocks, {lay['smem_bytes']} bytes a block "
                               f"({lay['ring_bytes']} of them the weight ring), "
                               f"{int(real.sum(0).max())} weight pieces a block")
        return out
    if name == "log_mel":
        from transformertts_tpu_torch.ops import stft

        out = []
        for n_fft, hop in ((AUDIO["n_fft"], AUDIO["hop_length"]), (512, 128), (2048, 512)):
            pl = stft.mel_kernel_plan(n_fft, hop, AUDIO["n_mels"])
            lib = stft._lib().tts_log_mel_fft_smem(n_fft, hop, AUDIO["n_mels"], pl["fpb"])
            if lib != pl["smem"]:
                raise AssertionError(f"mel_kernel_plan {pl['smem']} != library {lib} bytes")
            out.append(f"FFT n_fft={n_fft} hop={hop}: {lib} bytes, {pl['fpb']} frames a block, "
                       f"radices {pl['radices']}")
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
    if any("ffn_fwd_tc" in ln for ln in serialized):
        raise AssertionError(f"{name}: ptxas serialized the wgmma of the bf16 forward")
    for line in smem_lines(name):
        log(f"[build] {name} dynamic shared memory per block, {line}")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        log(f"[build] {name}: cuobjdump not available")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, mma, fn, body = {}, {}, None, {}
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            counts[fn], mma[fn], body[fn] = 0, 0, []
        elif fn is not None and "/*" in ln and ";" in ln:
            body[fn].append(ln)
            counts[fn] += "HGMMA" in ln
            mma[fn] += "HMMA" in ln
    per = ", ".join(f"{short} {n}" for short, n in zip(demangle(list(counts)), counts.values()))
    log(f"[build] {name}: {sum(counts.values())} HGMMA instructions in the SASS ({per})")
    for must in {"fused_ffn": ("ffn_dh_tc", "ffn_grad_tc", "ffn_fwd_tc"),
                 "flash_attention": ("_tc",)}.get(name, ()):
        if not any(must in fn and n > 0 for fn, n in counts.items()):
            raise AssertionError(f"{name}: no HGMMA instruction in a kernel named *{must}*")
    if name == "decode_step_verify":  # mma.sync: HMMA in bf16, none in fp32
        per = dict(zip(demangle(list(mma)), mma.values()))
        log(f"[build] {name}: HMMA (mma.sync) instructions in the SASS: "
            + ", ".join(f"{short} {n}" for short, n in per.items()))
        if any((n > 0) != ("bfloat16" in short) for short, n in per.items()):
            raise AssertionError(f"{name}: a bf16 kernel without HMMA or an fp32 one with it: {per}")
    for fn, lines in body.items():
        if "ffn_fwd_tc" in fn and "ILi64E" in fn:
            # the slice's epilogue: the instructions between the last product of
            # hp and the first of y, for the 32 intermediate elements a thread holds
            at = [i for i, ln in enumerate(lines) if "HGMMA" in ln]
            gap = max((b - a - 1 for a, b in zip(at, at[1:])), default=0)
            log(f"[build] fused_ffn: {demangle([fn])[0]}: {len(lines)} SASS instructions; the "
                f"widest gap between two HGMMAs (the slice's epilogue) {gap} instructions, "
                f"{gap / 32:.1f} per intermediate element")


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
    log(f"[kernel] one call under the profiler: 1 kernel launch ({kernels[0][:80]})")


def phase_kernel(cfg, device) -> dict:
    """Kernel vs plain version at ``Config()`` and ``paper.yaml`` widths,
    each case twice for equal bits; returns the max errors by batch."""
    import torch

    from transformertts_tpu_torch.ops.decode_step import (
        DecodeVerify,
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
                # and the verify form (the spec phase checks it against its
                # plain version): a pass is one launch of the K = 4 instance
                vc, rest = verify_inputs(wcfg, SPEC_K, SERVE_MAX_LEN, 64, dtype, device, 9, alpha)
                verify = DecodeVerify(*vc, packed, *rest, k=SPEC_K, r=wcfg.model.reduction_factor,
                                      n_pos=SERVE_MAX_LEN, tau=1e9, stop_threshold=2.0)
                calls = [
                    (lambda: decode_step(200, frame, pe_row, bias, *caches, packed),
                     "decode_step_kernel"),
                    (lambda: decode_step(200, frame, pe_row, bias, *caches, packed,
                                         **prenet_drop(cfg, 3)), "decode_step_kernel"),
                    (lambda: verify(200), f"decode_verify_kernel<__nv_bfloat16, {SPEC_K}>"),
                ]
                # every library loaded before the first profiler session: on
                # the card the profiler showed no kernel of the verify
                # library when it was first loaded after two sessions
                for call, _ in calls:
                    call()
                for call, name in calls:
                    check_one_launch(call, name)
                del vc, rest, verify
    kernel_prenet_dropout(cfg, device, worst)
    return worst


def prenet_drop(cfg, row0: int) -> dict:
    """The decode step's prenet-dropout arguments at ``PRENET_DROPOUT``, the
    decode's seed and first row ``row0``."""
    return {"prenet_dropout": PRENET_DROPOUT, "seed": cfg.training.seed ^ 0x5EED, "row0": row0}


def kernel_prenet_dropout(cfg, device, worst: dict) -> None:
    """The decode step with prenet dropout against its plain version with the
    same seed and first row, at ``Config()`` widths, 1,500 positions and 192
    encoder positions, each case twice for equal bits."""
    import torch

    from transformertts_tpu_torch.ops.decode_step import (
        decode_step,
        decode_step_reference,
        pack_decode_weights,
    )

    drop = prenet_drop(cfg, 3)
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        model = make_model(cfg, dtype, device, seed=1)
        packed = pack_decode_weights(model, dtype)
        alpha = float(model.pe.alpha.detach())
        del model
        for b in (1, 8):
            for t in (0, 700):
                (frame, pe_row, bias), caches = step_inputs(
                    cfg, b, t, 1500, 192, dtype, device, seed=b * 1000 + t + 1)
                pe_row = alpha * pe_row
                outs = [decode_step(t, frame, pe_row, bias, *[c.clone() for c in caches],
                                    packed, **drop) for _ in range(2)]
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(*outs)):
                    raise AssertionError(f"prenet dropout {dtype_name} B={b} t={t}: a second "
                                         "call gave other bits")
                ref = decode_step_reference(t, frame, pe_row, bias, *caches, packed, **drop)
                kept = decode_step_reference(t, frame, pe_row, bias, *caches, packed)
                errs = []
                for name, o, r in zip(("y", "k_new", "v_new"), outs[0], ref):
                    err, rel = rel_err(o, r)
                    errs.append(f"{name} {err:.2e}")
                    worst[b] = max(worst.get(b, 0.0), err)
                    if not rel <= TOL[dtype_name] or not torch.isfinite(o).all():
                        raise AssertionError(f"kernel != plain with prenet dropout: {dtype_name} "
                                             f"B={b} t={t} {name}: rel err {rel:.3g}")
                moved = rel_err(outs[0][0], kept[0])[1]
                if not moved > 5 * TOL[dtype_name]:
                    raise AssertionError(f"prenet dropout {dtype_name} B={b} t={t}: the output "
                                         f"moved only {moved:.2e} from the undropped one")
                log(f"[kernel] Config() {dtype_name:8s} B={b} t={t:4d} prenet dropout "
                    f"{PRENET_DROPOUT} (row0 3): " + ", ".join(errs)
                    + f", equal bits; {moved:.2e} (relative) from the undropped step")


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


def ran_kernel(call, want: str, device):
    """``call()``'s result, after checking that on the card it launched the
    log-mel kernel ``want`` ("fft" or "dense") once and no other."""
    from transformertts_tpu_torch.ops.stft import log_mel

    before = (log_mel.launches_fft, log_mel.launches_dense)
    out = call()
    ran = (log_mel.launches_fft - before[0], log_mel.launches_dense - before[1])
    if device.type == "cuda" and ran != ((1, 0) if want == "fft" else (0, 1)):
        raise AssertionError(f"log_mel launched {ran} (FFT, dense) kernels, wanted one {want}")
    return out


def phase_mel_kernel(device) -> dict:
    """Row 9 against its plain version and the numpy FFT; worst abs errors.
    Config()'s n_fft 1,024 and 512, 2,048 run on the FFT kernel, 800 on the
    dense one."""
    import torch

    from transformertts_tpu_torch.dsp import mel_spectrogram_np
    from transformertts_tpu_torch.ops.stft import log_mel

    worst: dict = {}
    rng = np.random.default_rng(9)
    hop = AUDIO["hop_length"]
    # one clip, center=True, 5 s: 110,250 samples, no multiple of the hop
    y = clip_signal(rng, 110250)
    t = torch.from_numpy(y).to(device)
    out = ran_kernel(lambda: log_mel(t, **AUDIO), "fft", device)
    if out.shape != (AUDIO["n_mels"], 1 + len(y) // hop):
        raise AssertionError(f"log_mel: {tuple(out.shape)} for {len(y)} samples")
    check_mel("one clip, center", out[None], log_mel(t, plain=True, **AUDIO)[None],
              [mel_spectrogram_np(y, **AUDIO)], worst)
    # the batch preprocess sends: 32 clips of 2-7.3 s in one 163,840-sample bucket
    clips = [clip_signal(rng, int(n)) for n in rng.integers(44100, MEL_BUCKET_LEN - 1024, MEL_BATCH)]
    t = torch.from_numpy(padded_batch(clips, MEL_BUCKET_LEN)).to(device)
    out = ran_kernel(lambda: log_mel(t, center=False, **AUDIO), "fft", device)
    if out.shape != (MEL_BATCH, AUDIO["n_mels"], 1 + (MEL_BUCKET_LEN - 1024) // hop):
        raise AssertionError(f"log_mel: {tuple(out.shape)} for the batch")
    check_mel(f"batch of {MEL_BATCH}, center=False", out, log_mel(t, center=False, plain=True, **AUDIO),
              [mel_spectrogram_np(c, **AUDIO) for c in clips], worst)
    # rows whose starts rule out 16-byte loads (odd padded length), center=True
    clips = [clip_signal(rng, 40001) for _ in range(3)]
    t = torch.from_numpy(np.stack(clips)).to(device)
    check_mel("3 clips of 40,001, center", ran_kernel(lambda: log_mel(t, **AUDIO), "fft", device),
              log_mel(t, plain=True, **AUDIO), [mel_spectrogram_np(c, **AUDIO) for c in clips],
              worst)
    # the FFT kernel's other sizes, and the dense kernel at an n_fft that is no
    # power of two with a window shorter than the frame; 2 clips, center=True
    for n_fft, hop_, win, want in ((512, 128, 512, "fft"), (2048, 512, 2048, "fft"),
                                   (800, 200, 640, "dense")):
        kw = dict(AUDIO, n_fft=n_fft, hop_length=hop_, win_length=win)
        clips = [clip_signal(rng, 60001) for _ in range(2)]
        t = torch.from_numpy(np.stack(clips)).to(device)
        check_mel(f"2 clips of 60,001, n_fft {n_fft}, hop {hop_}, window {win} ({want})",
                  ran_kernel(lambda: log_mel(t, **kw), want, device), log_mel(t, plain=True, **kw),
                  [mel_spectrogram_np(c, **kw) for c in clips], worst)
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
    for rate, window in ((0.0, 0), (0.0, 2), (PRENET_DROPOUT, 0), (PRENET_DROPOUT, 2)):
        c = cfg.replace(runtime=dataclasses.replace(cfg.runtime, decode_attn_window=window,
                                                    infer_prenet_dropout=rate))
        outs = [
            make_decode_fn(model, c, max_len=64, stop_threshold=2.0, use_kernel=k,
                           device=device)(phoneme, lens)
            for k in (True, False)
        ]
        kern, plain = outs
        if not kern["n_frames"] == plain["n_frames"] == 64 or not torch.equal(
                kern["n_frames_per_row"], plain["n_frames_per_row"]):
            raise AssertionError(f"W={window} prenet dropout {rate}: frame counts differ")
        # how the gap grows along the fed-back frames, by 16 frames
        gap = (kern["pred_melspec"] - plain["pred_melspec"]).abs().amax(dim=(0, 2))
        growth = ", ".join(f"{float(gap[i:i + 16].max()):.1e}" for i in range(0, 64, 16))
        msg = []
        for k in ("pred_melspec", "pred_stop", "post_melspec"):
            err, rel = rel_err(kern[k], plain[k])
            msg.append(f"{k} {err:.2e} (rel {rel:.1e})")
            if not rel <= DECODE_TOL:
                raise AssertionError(f"W={window} prenet dropout {rate}: kernel loop != plain "
                                     f"loop on {k}: {rel:.3g} (pred_melspec gap by 16 frames: "
                                     f"{growth})")
        log(f"[decode] fp32 B=2 64 frames W={window} prenet dropout {rate}: " + ", ".join(msg)
            + f"; pred_melspec gap by 16 frames {growth}")
    check_naive_decode(device)
    from transformertts_tpu_torch.ops.decode_step import decode_step

    bf16 = make_model(cfg, torch.bfloat16, device, seed=6)
    ids = torch.as_tensor(rng.integers(1, 70, (8, 96)), device=device)
    ids_lens = torch.as_tensor(rng.integers(48, 97, 8), device=device)
    check_late_readback(
        "decode", lambda th: make_decode_fn(bf16, cfg, max_len=LATE_STEPS, stop_threshold=th,
                                            device=device)(ids, ids_lens),
        lambda: decode_step.launches, "decode_step_kernel", card_line())


LATE_STEPS = 576  # the serving cells' forced steps a request


def check_late_readback(what: str, decode, steps, kernel: str, card: str) -> None:
    """``decode(threshold)`` (a B 8 decode of ``LATE_STEPS`` positions on
    the card, inputs on the device) with the stop votes read back ``LAG``
    steps late, against the same decode read back after every step (``LAG``
    1), as the module docstring says; ``steps()`` reads the step kernel's
    launch counter and ``kernel`` names the kernel in the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from transformertts_tpu_torch.infer import decode as decode_mod
    from transformertts_tpu_torch.utils import trace

    lag = decode_mod.LAG

    def run(at: int, threshold: float = 2.0):
        decode_mod.LAG = at
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            out = decode(threshold)
            torch.cuda.synchronize()
        finally:
            decode_mod.LAG = lag
        return out, [s for s in trace.spans() if s.name == "decode.loop" and s.start_ns >= t0]

    run(lag)  # warm
    before = steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        late, loops = run(lag)
    launches = steps() - before
    events = prof.events()
    span = [e.time_range for e in events if e.name == "decode.loop"]
    syncs = sum(e.name in ("cudaEventSynchronize", "cudaStreamSynchronize")
                and span[0].start <= e.time_range.start <= span[0].end for e in events)
    recorded = sum(e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
                   for e in events)
    each, _ = run(1)
    most = math.ceil(LATE_STEPS / lag) + 2
    log(f"[{what}] B 8, {LATE_STEPS} forced steps, LAG {lag}, under torch.profiler: "
        f"{syncs} host waits on the device inside decode.loop (at most {most}; the span's "
        f"waits {loops[0].attrs['waits']}), {launches} step launches ({recorded} recorded by the "
        f"profiler), overrun {loops[0].attrs['overrun']}")
    if not (len(span) == 1 and 0 < syncs <= most and launches == late["n_steps"] == LATE_STEPS
            >= recorded and loops[0].attrs["overrun"] == 0):
        raise AssertionError(f"{what}: the late readback waited {syncs} times or launched "
                             f"{launches} kernels for {late['n_steps']} steps")
    for k in ("pred_melspec", "pred_stop", "post_melspec"):
        if not torch.equal(late[k], each[k]):
            raise AssertionError(f"{what}: {k} read LAG {lag} steps late differs from LAG 1")
    ms = {}
    for at in (1, lag, lag, 1):
        _, loops = run(at)
        ms.setdefault(at, []).append(loops[0].ns / 1e6 / loops[0].attrs["steps"])
    log(f"[{what}] decode.loop ms a step in turns (1, {lag}, {lag}, 1): LAG 1 "
        + " / ".join(f"{v:.4f}" for v in ms[1]) + f", LAG {lag} "
        + " / ".join(f"{v:.4f}" for v in ms[lag]) + f" [{card}]")
    # a stop inside the decode: the threshold each row's running peak has
    # reached by the middle step, a little lower, so every row has voted by then
    mid = LATE_STEPS // 2
    peak = torch.sigmoid(late["pred_stop"].float()).cummax(dim=1).values
    threshold = float(peak[:, mid].min()) * (1 - 1e-4)
    want = int((peak.min(dim=0).values >= threshold).float().argmax()) + 1
    stop_late, loops = run(lag, threshold)
    stop_each, _ = run(1, threshold)
    log(f"[{what}] stop threshold {threshold:.6f}: {stop_late['n_steps']} steps at LAG {lag} "
        f"(overrun {loops[0].attrs['overrun']} rolled back, {loops[0].attrs['waits']} waits), "
        f"{stop_each['n_steps']} at LAG 1, {want} from the forced run's logits")
    if not stop_late["n_steps"] == stop_each["n_steps"] <= mid + 1:
        raise AssertionError(f"{what}: the stop moved with LAG")
    for k in ("pred_melspec", "pred_stop", "post_melspec", "n_frames_per_row"):
        if not torch.equal(stop_late[k], stop_each[k]):
            raise AssertionError(f"{what}: {k} of a stopped decode differs between LAG {lag} "
                                 "and LAG 1")


NAIVE_FRAMES = 32


def check_naive_decode(device) -> None:
    """The kernel decode at ``large_tp.yaml`` widths (d_model 1,024, 16
    heads, d_ffn 4,096, 6 layers), fp32, B = 1 and 8, against the cacheless
    ``naive_decode`` over 32 fed-back frames, within ``DECODE_TOL``; logs the
    cluster plan the kernel took (``card_plan``)."""
    import torch

    from transformertts_tpu_torch.infer.decode import make_decode_fn, naive_decode
    from transformertts_tpu_torch.ops import decode_step

    cfg = large_tp_config()
    model = make_model(cfg, torch.float32, device, seed=4)
    rng = np.random.default_rng(8)
    for b in (1, 8):
        phoneme = rng.integers(1, 70, (b, 64))
        lens = rng.integers(32, 65, b)
        lens[0] = 64
        kern = make_decode_fn(model, cfg, max_len=NAIVE_FRAMES, stop_threshold=2.0,
                              device=device)(phoneme, lens)
        naive = naive_decode(model, phoneme, lens, NAIVE_FRAMES, stop_threshold=2.0)
        if not kern["n_frames"] == naive["n_frames"] == NAIVE_FRAMES:
            raise AssertionError(f"large_tp B={b}: frame counts {kern['n_frames']} / "
                                 f"{naive['n_frames']}")
        msg = []
        for k in ("pred_melspec", "pred_stop", "post_melspec"):
            err, rel = rel_err(kern[k], naive[k])
            msg.append(f"{k} {err:.2e} (rel {rel:.1e})")
            if not rel <= DECODE_TOL:
                raise AssertionError(f"large_tp B={b}: kernel decode != naive_decode on {k}: "
                                     f"{rel:.3g}")
        m = cfg.model
        plans = [decode_step.card_plan(m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels,
                                       m.n_mels * m.reduction_factor + m.reduction_factor, b,
                                       m.decoder_n_head, n_pos, 64, dtype)[:2]
                 for n_pos, dtype in ((NAIVE_FRAMES, torch.float32),
                                      (SERVE_MAX_LEN, torch.bfloat16))]
        log(f"[decode] large_tp.yaml fp32 B={b} {NAIVE_FRAMES} frames, kernel decode vs "
            f"naive_decode: {', '.join(msg)}; (blocks a cluster, rows a cluster): {plans[0]} "
            f"(bf16 at {SERVE_MAX_LEN} positions: {plans[1]})")
    check_large_tp_bf16(device)


def check_large_tp_bf16(device) -> None:
    """The decode step at ``large_tp.yaml`` widths in bf16 (the serving
    dtype) against its plain version (``decode_step_reference``), B = 1 and
    8, at the serving shape (400 positions, 64 encoder positions), t 0, 200
    and 399, the expected position on: every output within ``TOL``, equal
    bits from a second call; logs the worst deviation and the plan taken."""
    import torch

    from transformertts_tpu_torch.ops.decode_step import (
        card_plan,
        decode_step,
        decode_step_reference,
        pack_decode_weights,
    )

    cfg = large_tp_config()
    m = cfg.model
    model = make_model(cfg, torch.bfloat16, device, seed=4)
    packed = pack_decode_weights(model, torch.bfloat16)
    alpha = float(model.pe.alpha.detach())
    del model
    for b in (1, 8):
        worst, worst_rel = 0.0, 0.0
        for t in (0, SERVE_MAX_LEN // 2, SERVE_MAX_LEN - 1):
            (frame, pe_row, bias), caches = step_inputs(cfg, b, t, SERVE_MAX_LEN, 64,
                                                        torch.bfloat16, device, seed=b * 100 + t)
            pe_row = alpha * pe_row
            outs = [decode_step(t, frame, pe_row, bias, *[c.clone() for c in caches], packed,
                                with_attn_pos=True) for _ in range(2)]
            if not all(torch.equal(x, y) for x, y in zip(*outs)):
                raise AssertionError(f"large_tp bf16 B={b} t={t}: a second call gave other bits")
            ref = decode_step_reference(t, frame, pe_row, bias, *caches, packed, True)
            for name, o, r in zip(("y", "k_new", "v_new", "pos"), outs[0], ref):
                err, rel = rel_err(o, r)
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                if not rel <= TOL["bfloat16"] or not torch.isfinite(o).all():
                    raise AssertionError(f"large_tp bf16 B={b} t={t}: kernel != plain on {name}: "
                                         f"rel err {rel:.3g}")
            del caches
        plan = card_plan(m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels,
                         m.n_mels * m.reduction_factor + m.reduction_factor, b, m.decoder_n_head,
                         SERVE_MAX_LEN, 64, torch.bfloat16)[:2] if device.type == "cuda" else None
        log(f"[decode] large_tp.yaml bf16 B={b} n_pos {SERVE_MAX_LEN} Tp 64 t 0/200/399, kernel vs "
            f"decode_step_reference: max abs err {worst:.2e} (rel {worst_rel:.2e}, TOL "
            f"{TOL['bfloat16']:g}); (blocks a cluster, rows a cluster) {plan}; equal bits")


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


STREAM_STATS = {"mean": -5.0, "std": 2.0}
CLI_MAX_LEN = 256  # frames a line of ``cli serve`` decodes in the stream phase


def padded_texts(synth, texts) -> tuple:
    """Phonemes of ``texts`` padded to the smallest bucket that holds the
    longest, and their lengths (as ``Synthesizer`` pads them)."""
    from transformertts_tpu_torch.data.dataset import pick_bucket

    seqs = [synth.text_to_ids(t) for t in texts]
    buckets = synth.cfg.runtime.phoneme_buckets
    bucket = pick_bucket(max(len(q) for q in seqs), buckets) or buckets[-1]
    phoneme = np.zeros((len(seqs), bucket), np.int32)
    lens = np.array([min(len(q), bucket) for q in seqs], np.int32)
    for i, q in enumerate(seqs):
        phoneme[i, :lens[i]] = q[:bucket]
    return phoneme, lens


def postnet_tol(model) -> float:
    """Tolerance of streamed postnet frames against the one-shot postnet:
    the same frames through convolutions of another length, for which cuDNN
    may pick another algorithm; in bf16 a value then moves by a bf16 ulp
    (2^-8 relative; 4.1e-3 measured at B = 10 on the H100), so ``TOL`` of the
    model's dtype rather than the fp32 ``DECODE_TOL``."""
    return TOL[str(model.dtype).removeprefix("torch.")]


def check_stream(what, cfg, synth, texts, device, card: str) -> dict:
    """One stream of ``texts`` through ``stream_chunks`` against the one-shot
    kernel decode; returns the decode step's launches (B = 1, B > 1)."""
    import torch

    from transformertts_tpu_torch.infer.decode import make_decode_fn
    from transformertts_tpu_torch.infer.streaming import make_stream_fns, stream_chunks
    from transformertts_tpu_torch.ops.decode_step import decode_step

    b, n_pos = len(texts), STREAM_MAX_LEN // cfg.model.reduction_factor
    phoneme, lens = padded_texts(synth, texts)
    # the kernel loop (on the card the default; on the CPU its plain version)
    one = make_decode_fn(synth.model, cfg, max_len=STREAM_MAX_LEN, use_kernel=True,
                         device=device)(phoneme, lens)
    fns = make_stream_fns(synth.model, cfg, max_len=STREAM_MAX_LEN, chunk=STREAM_CHUNK,
                          use_kernel=True, device=device)
    on_card = device.type == "cuda"  # only a kernel launch counts
    decode_step.launches = decode_step.launches_batched = 0
    state = fns[0](phoneme, lens)
    chunks = list(stream_chunks(fns, cfg, state, STREAM_MAX_LEN))
    launches = {"b1": decode_step.launches - decode_step.launches_batched,
                "batched": decode_step.launches_batched}
    pre = np.concatenate([c[0] for c in chunks], axis=1)
    post = np.concatenate([c[1] for c in chunks], axis=1)
    steps = sum(c[2] for c in chunks)
    per_chunk = [(rows.b, rows.t, rows.decode_step.launches if on_card else rows.t)
                 for rows in state.rows]
    want_rows = [min(8, b - i) for i in range(0, b, 8)]
    if pre.shape != (b, STREAM_MAX_LEN, cfg.model.n_mels) or one["n_frames"] != STREAM_MAX_LEN:
        raise AssertionError(f"[stream] {what} B={b}: {pre.shape} streamed, one-shot "
                             f"{one['n_frames']} frames")
    if not np.array_equal(pre, one["pred_melspec"].cpu().numpy()):
        raise AssertionError(f"[stream] {what} B={b}: streamed frames != one-shot frames")
    err, rel = rel_err(torch.from_numpy(post), one["post_melspec"].cpu())
    if not rel <= postnet_tol(synth.model) or not np.isfinite(post).all():
        raise AssertionError(f"[stream] {what} B={b}: postnet chunks off by {rel:.3g}")
    if ([rb for rb, _, _ in per_chunk] != want_rows
            or any(t != n_pos or n != n_pos for _, t, n in per_chunk)
            or (on_card and steps != sum(launches.values()))
            or steps != n_pos * len(want_rows)):
        raise AssertionError(f"[stream] {what} B={b}: row chunks (rows, steps, launches) "
                             f"{per_chunk}, {steps} steps, launches {launches}")
    log(f"[stream] {what} bf16 B={b}: {len(chunks)} chunks of <= {STREAM_CHUNK} frames, "
        f"pre-postnet frames equal to the one-shot kernel decode's bit for bit, postnet "
        f"{err:.2e} (rel {rel:.1e}); row chunks (rows, steps, launches) {per_chunk} in "
        f"lockstep [{card}]")
    return launches


def time_stream(what, synth, card: str) -> dict:
    """``Synthesizer.stream`` of one text beside ``Synthesizer.synthesize``
    (each returns host arrays: the device is drained at each chunk), and the
    stream's set-up alone (encoder, cross K/V, the prepared decode step)."""
    import statistics

    import torch

    from transformertts_tpu_torch.infer.streaming import make_stream_fns

    text = TEXTS[0]
    list(synth.stream(text, chunk=STREAM_CHUNK, max_len=STREAM_MAX_LEN))  # warm
    synth.synthesize(text, max_len=STREAM_MAX_LEN)
    init = make_stream_fns(synth.model, synth.cfg, max_len=STREAM_MAX_LEN, chunk=STREAM_CHUNK,
                           device=synth.device)[0]
    phoneme, lens = padded_texts(synth, [text])
    init(phoneme, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init(phoneme, lens)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    stamps, mels = [], []
    t0 = time.perf_counter()
    for mel in synth.stream(text, chunk=STREAM_CHUNK, max_len=STREAM_MAX_LEN):
        stamps.append(time.perf_counter() - t0)
        mels.append(mel)
    t0 = time.perf_counter()
    whole = synth.synthesize(text, max_len=STREAM_MAX_LEN)[0]
    one_s = time.perf_counter() - t0
    streamed = np.concatenate(mels, axis=1)
    if streamed.shape != whole.shape or not rel_err(
            torch.from_numpy(streamed), torch.from_numpy(whole))[1] <= postnet_tol(synth.model):
        raise AssertionError(f"[stream] {what}: Synthesizer.stream != synthesize")
    later = [b - a for a, b in zip(stamps, stamps[1:])]
    frames = streamed.shape[1]
    out = {"first_ms": stamps[0] * 1e3, "later_ms": statistics.median(later) * 1e3,
           "fps": frames / stamps[-1], "synth_fps": frames / one_s, "init_ms": init_ms}
    log(f"[stream] {what} Synthesizer.stream B=1, {frames} frames in chunks of {STREAM_CHUNK}: "
        f"first chunk after {out['first_ms']:.1f} ms ({init_ms:.1f} ms of it the set-up: "
        f"encoder, cross K/V, decode step prepared), later chunks every {out['later_ms']:.1f} "
        f"ms (median; max {max(later) * 1e3:.1f}), {out['fps']:.0f} frames/s; "
        f"Synthesizer.synthesize of the same text {one_s * 1e3:.1f} ms, {out['synth_fps']:.0f} "
        f"frames/s [{card}]")
    return out


def phase_stream(device, root, card: str) -> dict:
    """Streaming synthesis on the decode-step kernel, ``cli serve`` and
    ``entry()``; returns the decode step's launches of the streams (B = 1,
    B > 1), each stream's counted from 0."""
    import dataclasses
    import wave

    import torch

    from transformertts_tpu_torch import cli
    from transformertts_tpu_torch.entry import entry
    from transformertts_tpu_torch.infer import Synthesizer
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.ops.decode_step import decode_step
    from transformertts_tpu_torch.train import create_train_state
    from transformertts_tpu_torch.train.checkpoint import CheckpointManager

    launches = {"b1": 0, "batched": 0}
    for what, base in (("Config()", default_config()), ("fast_serve.yaml", fast_serve_config())):
        cfg = base.replace(runtime=dataclasses.replace(base.runtime, stop_threshold=2.0))
        gen_model = make_model(cfg, torch.bfloat16, "cpu", seed=6)
        synth = Synthesizer(cfg, state_dict=gen_model.state_dict(), stats=STREAM_STATS,
                            device=device)
        del gen_model
        for texts in (TEXTS[:1], TEXTS[:10]):
            for key, n in check_stream(what, cfg, synth, texts, device, card).items():
                launches[key] += n
        time_stream(what, synth, card)
        del synth

    # cli serve --wav: two lines on a checkpoint of the port's format
    cfg = default_config()
    model = TransformerTTS(cfg.model, device="cpu", generator=torch.Generator().manual_seed(8))
    CheckpointManager(root / "ckpt").save(1, create_train_state(model, cfg), epoch=1)
    del model
    (root / "lines.txt").write_text(f"{TEXTS[1]}\n\n{TEXTS[2]}\n")
    decode_step.launches = decode_step.launches_batched = 0
    t0 = time.perf_counter()
    cli.main(["serve", "--ckpt", str(root / "ckpt"), "--out-dir", str(root / "served"),
              "--input", str(root / "lines.txt"), "--wav", "--chunk", str(STREAM_CHUNK),
              "--device", str(device),
              *[a for s in (f"runtime.infer_max_len={CLI_MAX_LEN}", "runtime.stop_threshold=2.0",
                            f"path.preprocessed={root}") for a in ("--set", s)]])
    t_cli = time.perf_counter() - t0
    names = sorted(p.name for p in (root / "served").iterdir())
    if names != ["utt_0000.npy", "utt_0000.wav", "utt_0001.npy", "utt_0001.wav"]:
        raise AssertionError(f"cli serve wrote {names}")
    for i in range(2):
        mel = np.load(root / "served" / f"utt_{i:04d}.npy")
        with wave.open(str(root / "served" / f"utt_{i:04d}.wav")) as w:
            n_samples = w.getnframes()
        if (mel.shape != (cfg.model.n_mels, CLI_MAX_LEN) or not np.isfinite(mel).all()
                or n_samples != (CLI_MAX_LEN - 1) * AUDIO["hop_length"]):
            raise AssertionError(f"cli serve line {i}: mel {mel.shape}, {n_samples} samples")
    if device.type == "cuda" and (decode_step.launches != 2 * CLI_MAX_LEN
                                  or decode_step.launches_batched):
        raise AssertionError(f"cli serve: {decode_step.launches} decode-step launches")
    log(f"[stream] cli serve --wav: 2 lines, {CLI_MAX_LEN} frames and "
        f"{(CLI_MAX_LEN - 1) * AUDIO['hop_length']} samples each, {decode_step.launches} B=1 "
        f"decode-step launches, {t_cli:.1f} s with the model's load [{card}]")

    # entry(): the flagship forward
    fn, args = entry(device)
    out = fn(*args)
    m = cfg.model
    want = {"pred_melspec": (16, 512, m.n_mels), "pred_stop": (16, 512),
            "post_melspec": (16, 512, m.n_mels),
            "alignments": (m.decoder_n_layers, 16, m.decoder_n_head, 512, 128)}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != want or not all(torch.isfinite(v).all() for v in out.values()):
        raise AssertionError(f"entry(): {got}")
    log(f"[stream] entry(): the flagship forward gives {got}")
    return launches


def log_stage_times(what: str, names: list, run, card: str, calls: int = 20) -> None:
    """A decode kernel's time by stage: the median over ``calls`` calls of
    each stage's work (slowest block) and cluster-barrier wait, from the
    kernel's global-timer stamps; ``run()`` makes one call and returns the
    timeline it stamped."""
    import statistics

    import torch

    from transformertts_tpu_torch.ops.decode_step import stage_times

    runs = []
    for _ in range(calls):
        tl = run()
        torch.cuda.synchronize()
        runs.append(stage_times(tl, len(names) - 1))
    med = [(statistics.median(r[i][0] for r in runs), statistics.median(r[i][1] for r in runs))
           for i in range(len(names))]
    work, wait = sum(m[0] for m in med), sum(m[1] for m in med)
    log(f"[time] {what} by stage (median of {calls} calls, global timer): "
        f"{len(names)} stages, work {work:.1f} us, barrier waits {wait:.1f} us "
        f"({wait / max(1, len(names) - 1):.2f} us each) [{card}]")
    log("[time]   " + ", ".join(f"{n} {w:.2f}+{x:.2f}" for n, (w, x) in zip(names, med)))


def step_stage_times(what, b, t, step_args, packed, card: str) -> None:
    """``log_stage_times`` of the decode step at one shape."""
    from transformertts_tpu_torch.ops.decode_step import _prepared_step

    frame, pe_row, bias, caches = step_args
    step = _prepared_step(*caches, packed, False)

    def run():
        tl = step.timeline_buffer()
        step(t, frame, pe_row, bias, timeline=tl)
        return tl

    log_stage_times(f"{what} bf16 B={b} t={t}", step.stages(t), run, card)


def phase_time(cfg, device, synth, card: str) -> tuple:
    """The decode step's times by shape (``rows``) and, at the serving shape,
    with prenet dropout (``drop_rows``: rate 0, rate ``PRENET_DROPOUT``,
    rate 0 again, by batch)."""
    import torch

    from transformertts_tpu_torch.ops.decode_step import (
        decode_step,
        decode_step_reference,
        pack_decode_weights,
    )

    from transformertts_tpu_torch.ops import decode_step as decode_module

    stamps = hasattr(decode_module, "stage_times")  # (an earlier kernel in a same-call A/B has none)
    rows, drop_rows = {}, {}
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
                if (what, n_pos, tp, t) == ("Config()", SERVE_MAX_LEN, 64, 200):
                    dropped = lambda: decode_step(  # noqa: E731
                        t, frame, pe_row, bias, *caches, packed, **prenet_drop(cfg, 0))
                    drop_ms, again_ms = device_ms(dropped), device_ms(kern)
                    drop_rows[b] = (ms, drop_ms, again_ms)
                    log(f"[time] Config() bf16 B={b} serving shape, prenet dropout: rate 0 "
                        f"{ms * 1e3:.1f} / {again_ms * 1e3:.1f} us/step (before / after), rate "
                        f"{PRENET_DROPOUT} {drop_ms * 1e3:.1f} us/step on the device [{card}]")
                if (n_pos, tp, t) in ((SERVE_MAX_LEN, 64, 200), (1500, 192, 700)) and stamps:
                    step_stage_times(what, b, t, (frame, pe_row, bias, caches), packed, card)
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
    return rows, drop_rows


# ------------------------------------------------------- speculative decode

SPEC_K = 4  # the main path's drafted positions a pass
SPEC_TAU_MID = 0.5  # the kernel check's second acceptance tolerance (stop threshold 0.5)


def spec_config(cfg, k: int = SPEC_K, tau=None, **runtime):
    """``cfg`` with speculative decode on: K = ``k``, tau ``tau`` (None keeps
    the config's)."""
    import dataclasses

    rt = cfg.runtime
    return cfg.replace(runtime=dataclasses.replace(
        rt, decode_speculative_k=k,
        decode_speculative_tau=rt.decode_speculative_tau if tau is None else tau, **runtime))


def verify_inputs(cfg, k, n_pos, tp, dtype, device, seed, alpha):
    """Seeded state of one utterance's verify pass, in ``DecodeVerify``'s
    order after the packed weights: caches of n_pos + K positions, cross
    K/V, a ragged cross bias (1, Tp), alpha * PE, a frame buffer of random
    frames and the stop buffer (drawn on the device, in bulk)."""
    import torch

    from transformertts_tpu_torch.models.masks import NEG_INF
    from transformertts_tpu_torch.models.modules import sinusoid_table

    m = cfg.model
    L, H, dh, r = m.decoder_n_layers, m.decoder_n_head, m.d_model // m.decoder_n_head, m.reduction_factor
    rng = np.random.default_rng(seed)
    n = int(rng.integers(tp // 2, tp + 1))
    bias = torch.from_numpy(np.where(np.arange(tp)[None, :] < n, 0.0, NEG_INF).astype(np.float32))
    pe = torch.from_numpy(alpha * sinusoid_table(n_pos + k, m.d_model)).float()
    gen = torch.Generator(device=device).manual_seed(seed)
    caches = [torch.randn((L, H, 1, c, dh), generator=gen, device=device).to(dtype)
              for c in (n_pos + k, n_pos + k, tp, tp)]
    frames = torch.randn((n_pos * r + 1, m.n_mels), generator=gen, device=device)
    stops = torch.full((n_pos * r,), NEG_INF, device=device)
    return caches, [x.to(device) for x in (bias, pe)] + [frames, stops]


def check_verify_kernel(what, cfg, ks, device, worst: dict) -> None:
    """The verify kernel against its plain version (``verify_pass_reference``)
    on the same state: K in ``ks``, t in {0, n_pos / 2, n_pos - K} at the
    serving shape (400 positions, 64 encoder positions), bf16 and fp32, at
    (tau 1e9, stop threshold 2.0: every draft accepted) and (tau
    ``SPEC_TAU_MID``, threshold 0.5).  Outputs within ``TOL``, the
    acceptance exactly ``accept_reference``'s of the kernel's own outputs,
    the accepted frames and stop logits written and nothing else, the K/V
    rows written at t .. t + K - 1 and nothing else, equal bits from a
    second call on the same state, and one launch counted a call (the
    kernel phase checks under the profiler that a call is one kernel)."""
    import torch

    from transformertts_tpu_torch.ops.decode_step import (
        DecodeVerify,
        accept_reference,
        draft_frames,
        pack_decode_weights,
        verify_pass_reference,
    )

    n_pos, tp, r, nm = SERVE_MAX_LEN, 64, cfg.model.reduction_factor, cfg.model.n_mels
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        model = make_model(cfg, dtype, device, seed=1)
        packed = pack_decode_weights(model, dtype)
        alpha = float(model.pe.alpha.detach())
        del model
        for k in ks:
            for t in (0, n_pos // 2, n_pos - k):
                caches, rest = verify_inputs(cfg, k, n_pos, tp, dtype, device, 10 * k + t, alpha)
                for tau, thr in ((1e9, 2.0), (SPEC_TAU_MID, 0.5)):
                    opts = dict(k=k, r=r, n_pos=n_pos, tau=tau, stop_threshold=thr)
                    state = [c.clone() for c in caches] + [x.clone() for x in rest]
                    verify = DecodeVerify(*state[:4], packed, *state[4:], **opts)
                    runs, before = [], DecodeVerify.launches_total
                    for _ in range(2):  # the same state twice: equal bits
                        for dst, src in zip(state, caches + rest):
                            dst.copy_(src)
                        code = int(verify(t))
                        runs.append([code] + [x.clone() for x in
                                              (verify.y, verify.k_new, verify.v_new, *state)])
                    if device.type == "cuda" and DecodeVerify.launches_total - before != 2:
                        raise AssertionError("a verify call did not count one launch")
                    if runs[0][0] != runs[1][0] or not all(
                            torch.equal(a, b) for a, b in zip(runs[0][1:], runs[1][1:])):
                        raise AssertionError(f"verify {what} {dtype_name} K={k} t={t}: a second "
                                             f"call gave other bits")
                    code, y, kn, vn, sk, sv, _, _, _, _, frames, stops = runs[0]
                    plain = [c.clone() for c in caches] + [x.clone() for x in rest]
                    p_code, *ref = verify_pass_reference(t, *plain[:4], packed, *plain[4:],
                                                         **opts)
                    errs = []
                    for name, o, rr in zip(("y", "k_new", "v_new"), (y, kn, vn), ref):
                        err, rel = rel_err(o, rr)
                        errs.append(f"{name} {err:.2e} (rel {rel:.1e})")
                        worst[k] = max(worst.get(k, 0.0), err)
                        if not rel <= TOL[dtype_name] or not torch.isfinite(o).all():
                            raise AssertionError(f"verify kernel != plain: {what} {dtype_name} "
                                                 f"K={k} t={t} tau={tau} {name}: rel {rel:.3g}")
                    drafts = draft_frames(rest[2], t, r, k)
                    want = int(accept_reference(y[:, :nm * r], y[:, nm * r:], drafts, r, tau,
                                                thr, n_pos - t))
                    m = code // 2
                    rows = slice(t * r + 1, t * r + 1 + m * r)
                    kept = torch.ones(frames.shape[0], dtype=torch.bool, device=device)
                    kept[rows] = False
                    if (code != want or not 1 <= m <= min(k, n_pos - t)
                            or not torch.equal(frames[rows], y[:, :nm * r].reshape(-1, nm)[:m * r])
                            or not torch.equal(frames[kept], rest[2][kept])
                            or not torch.equal(stops[t * r: t * r + m * r],
                                               y[:, nm * r:].reshape(-1)[:m * r])
                            or not torch.equal(stops[t * r + m * r:], rest[3][t * r + m * r:])):
                        raise AssertionError(f"verify {what} {dtype_name} K={k} t={t} tau={tau}: "
                                             f"code {code} (of its own outputs {want}) or the "
                                             f"frames / stops it wrote")
                    if tau == 1e9 and code != int(p_code):
                        raise AssertionError(f"verify {what} {dtype_name} K={k} t={t}: code {code}"
                                             f" != plain {int(p_code)} accepting every draft")
                    pos = torch.arange(n_pos + k, device=device)
                    own = (pos >= t) & (pos < t + k)
                    for c, new, orig in ((sk, kn, caches[0]), (sv, vn, caches[1])):
                        if not torch.equal(c[:, :, 0, own], new) or not torch.equal(
                                c[:, :, 0, ~own], orig[:, :, 0, ~own]):
                            raise AssertionError("verify kernel wrote cache rows other than "
                                                 "t .. t + K - 1, or not those")
                    log(f"[spec] {what} {dtype_name:8s} K={k} t={t:3d} tau={tau:g} thr={thr}: "
                        + ", ".join(errs) + f", m {m} vote {code & 1} (plain m {int(p_code) // 2} vote {int(p_code) & 1}), "
                        f"equal bits")
                del caches, rest


def check_spec_decode(cfg, device, card: str) -> None:
    """Whole speculative decodes at B = 1, ``Config()``, fp32, 64 forced
    frames: tau 0 against the sequential kernel decode (one group a pass),
    tau 1e9 at K = 4 (16 passes) and K = 3 (22, the last one cut at n_pos)
    and the kernel loop against the plain chunk loop at tau 1e9; at the
    default tau the groups a pass on these seeded weights (not a quality
    figure).  On the card each pass is one verify launch."""
    import math

    import torch

    from transformertts_tpu_torch.infer.decode import make_decode_fn
    from transformertts_tpu_torch.ops.decode_step import DecodeVerify, decode_step

    model = make_model(cfg, torch.float32, device, seed=2)
    rng = np.random.default_rng(3)
    phoneme, lens, frames = rng.integers(1, 70, (1, 96)), np.array([96]), 64

    def run(c, use_kernel=None):
        DecodeVerify.launches_total = decode_step.launches = 0
        out = make_decode_fn(model, c, max_len=frames, stop_threshold=2.0, use_kernel=use_kernel,
                             device=device)(phoneme, lens)
        if device.type == "cuda" and use_kernel is not False and (
                DecodeVerify.launches_total != out.get("n_verify_passes", 0)
                or decode_step.launches != (0 if "n_verify_passes" in out else out["n_steps"])):
            raise AssertionError(f"{DecodeVerify.launches_total} verify and "
                                 f"{decode_step.launches} step launches for {out['n_steps']} steps")
        if out["n_frames"] != frames:
            raise AssertionError(f"a forced decode gave {out['n_frames']} frames")
        return out

    def close(a, b, what):
        msg = []
        for key in ("pred_melspec", "pred_stop", "post_melspec"):
            err, rel = rel_err(a[key], b[key])
            msg.append(f"{key} {err:.2e} (rel {rel:.1e})")
            if not rel <= DECODE_TOL:
                raise AssertionError(f"{what}: {key} off by {rel:.3g}")
        return ", ".join(msg)

    seq = run(cfg)
    for k, tau, passes in ((SPEC_K, 0.0, frames), (SPEC_K, 1e9, frames // SPEC_K),
                           (3, 1e9, math.ceil(frames / 3))):
        out = run(spec_config(cfg, k, tau))
        if out["n_verify_passes"] != passes:
            raise AssertionError(f"K={k} tau={tau}: {out['n_verify_passes']} passes, want {passes}")
        msg = close(out, seq, f"K={k} tau 0 against the sequential decode") if tau == 0.0 else ""
        if tau == 1e9 and k == SPEC_K:
            msg = "against the plain chunk loop " + close(
                out, run(spec_config(cfg, k, tau), use_kernel=False), "kernel vs plain chunk loop")
        log(f"[spec] decode fp32 B=1 {frames} frames K={k} tau={tau:g}: {passes} verify passes"
            + (f", against the sequential kernel decode {msg}" if tau == 0.0 else f", {msg}")
            + f" [{card}]")
    out = run(spec_config(cfg))
    log(f"[spec] decode fp32 B=1 {frames} frames K={SPEC_K} default tau "
        f"{cfg.runtime.decode_speculative_tau}: {out['n_verify_passes']} passes, "
        f"{frames / out['n_verify_passes']:.2f} groups a pass (seeded random weights)")


def phase_spec(cfg, device, root, card: str) -> dict:
    """The verify kernel against its plain version at ``Config()`` (K 2, 4,
    8) and ``paper.yaml`` widths (K 4), whole decodes, then the path a user
    takes with ``runtime.decode_speculative_k=4``: ``Synthesizer.synthesize``
    of one text (bf16, 400 frames) and ``cli synthesize`` on a checkpoint
    the phase writes; returns the verify launches of that path, counted from
    0, and the kernel check's max errors by K."""
    import dataclasses

    import torch

    from transformertts_tpu_torch import cli
    from transformertts_tpu_torch.infer import Synthesizer
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.ops.decode_step import DecodeVerify, decode_step
    from transformertts_tpu_torch.train import create_train_state
    from transformertts_tpu_torch.train.checkpoint import CheckpointManager

    worst: dict[int, float] = {}
    check_verify_kernel("Config()", cfg, (2, SPEC_K, 8), device, worst)
    check_verify_kernel("paper.yaml", paper_config(), (SPEC_K,), device, worst)
    check_spec_decode(cfg, device, card)

    scfg = spec_config(cfg.replace(runtime=dataclasses.replace(cfg.runtime, stop_threshold=2.0)))
    gen_model = make_model(scfg, torch.bfloat16, "cpu", seed=5)
    synth = Synthesizer(scfg, state_dict=gen_model.state_dict(), stats=STREAM_STATS,
                        device=device)
    del gen_model
    ckpt_cfg = default_config()  # what cli synthesize builds without --config
    model = TransformerTTS(ckpt_cfg.model, device="cpu",
                           generator=torch.Generator().manual_seed(8))
    CheckpointManager(root / "ckpt").save(1, create_train_state(model, ckpt_cfg), epoch=1)
    del model
    sets = [f"runtime.decode_speculative_k={SPEC_K}", f"runtime.infer_max_len={CLI_MAX_LEN}",
            "runtime.stop_threshold=2.0", f"path.preprocessed={root}"]
    # the main path: counts from 0 just before, read just after
    DecodeVerify.launches_total = decode_step.launches = decode_step.launches_batched = 0
    synth.steps_decoded = 0
    mel = synth.synthesize(TEXTS[0], max_len=SERVE_MAX_LEN)[0]
    passes = synth.steps_decoded
    cli.main(["synthesize", "--ckpt", str(root / "ckpt"), "--text", TEXTS[1],
              "--out", str(root / "mel.npy"), "--device", str(device),
              *[a for s in sets for a in ("--set", s)]])
    launches, steps = DecodeVerify.launches_total, decode_step.launches
    cli_mel = np.load(root / "mel.npy")
    if (mel.shape != (cfg.model.n_mels, SERVE_MAX_LEN) or not np.isfinite(mel).all()
            or cli_mel.shape != (cfg.model.n_mels, CLI_MAX_LEN) or not np.isfinite(cli_mel).all()):
        raise AssertionError(f"speculative synthesize {mel.shape}, cli {cli_mel.shape}")
    if device.type == "cuda" and (steps != 0 or launches <= passes or passes <= 0):
        raise AssertionError(f"the speculative path launched {launches} verify kernels "
                             f"({passes} passes in synthesize) and {steps} decode steps")
    log(f"[spec] Synthesizer.synthesize bf16 K={SPEC_K} default tau: {SERVE_MAX_LEN} frames in "
        f"{passes} verify passes; cli synthesize --set runtime.decode_speculative_k={SPEC_K}: "
        f"{cli_mel.shape[1]} frames; {launches} verify launches, {steps} decode-step launches "
        f"[{card}]")
    # a batch falls through to the step kernel
    DecodeVerify.launches_total = decode_step.launches = decode_step.launches_batched = 0
    synth.synthesize(TEXTS[:2], max_len=64)
    if device.type == "cuda" and (DecodeVerify.launches_total or decode_step.launches_batched != 64):
        raise AssertionError("a B = 2 batch did not fall through to the decode-step kernel")
    return {"launches": launches, "worst": worst}


def verify_bytes_flops(packed, k, t, tp, cfg):
    """Least bytes a verify pass must move (the weights, the cache prefix and
    the cross K/V once for all K rows; the inputs, the K/V rows, the outputs
    and the accepted frames once) and the operations it must do."""
    m = cfg.model
    L, H, dh, r = m.decoder_n_layers, m.decoder_n_head, m.d_model // m.decoder_n_head, m.reduction_factor
    es = packed["pw1"].element_size()
    n_w = sum(p.numel() for p in packed.values())
    w_bytes = sum(p.numel() * p.element_size() for p in packed.values())
    cache = 2 * L * H * (t + tp) * dh * es
    d_out = packed["head_w"].shape[0]
    io_bytes = (4 * (2 * m.n_mels + k * m.d_model + tp + k * d_out + k * r * (m.n_mels + 1) + 1)
                + 2 * 2 * L * H * k * dh * es)  # K/V rows into the cache and out
    flops = 2 * k * n_w + 4 * L * H * dh * (k * (t + tp) + k * (k + 1) // 2)
    return w_bytes + cache + io_bytes, flops


VERIFY_TIMED = (("bfloat16", 2), ("bfloat16", SPEC_K), ("bfloat16", 8), ("float32", SPEC_K))


def time_verify_passes(cfg, device, card: str) -> dict:
    """The verify kernel's device time per pass by CUDA-graph replay at the
    serving shape (400 positions, 64 encoder positions, t 200): K 2, 4, 8 in
    bf16 and K 4 in fp32 at ``Config()``, K 4 in bf16 at ``paper.yaml``
    widths, each beside the B = 1 step's of the same dtype, its plain
    version's (eager: it reads the acceptance back) and its bound, with the
    host's time per eager call and the time by stage.  Returns the kernel's
    rows by (widths, dtype, K)."""
    import torch

    from transformertts_tpu_torch.ops.decode_step import (
        DecodeVerify,
        decode_step,
        pack_decode_weights,
        pack_verify_weights,
        verify_pass_reference,
    )

    rows, t, n_pos, tp = {}, 200, SERVE_MAX_LEN, 64
    for what, wcfg, cases in (("Config()", cfg, VERIFY_TIMED),
                              ("paper.yaml", paper_config(), (("bfloat16", SPEC_K),))):
        for dtype_name in dict.fromkeys(d for d, _ in cases):
            dtype = getattr(torch, dtype_name)
            model = make_model(wcfg, dtype, device, seed=1)
            packed = pack_decode_weights(model, dtype)
            alpha = float(model.pe.alpha.detach())
            del model
            weights = pack_verify_weights(packed)
            (frame, pe_row, bias), step_caches = step_inputs(wcfg, 1, t, n_pos, tp, dtype,
                                                             device, seed=7)
            pe_row = alpha * pe_row
            step_ms = device_ms(lambda: decode_step(t, frame, pe_row, bias, *step_caches, packed))
            del step_caches
            for k in (k for d, k in cases if d == dtype_name):
                caches, rest = verify_inputs(wcfg, k, n_pos, tp, dtype, device, 7, alpha)
                opts = dict(k=k, r=wcfg.model.reduction_factor, n_pos=n_pos, tau=1e9,
                            stop_threshold=2.0)
                verify = DecodeVerify(*caches, packed, *rest, **opts, verify_weights=weights)
                ms = device_ms(lambda: verify(t))
                host = host_us(lambda: verify(t))
                plain_ms = time_ms(
                    lambda: verify_pass_reference(t, *caches, packed, *rest, **opts), 5, 1)
                nbytes, flops = verify_bytes_flops(packed, k, t, tp, wcfg)
                peak = PEAK_BF16_FLOPS if dtype_name == "bfloat16" else PEAK_FP32_FLOPS
                bound = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
                by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak else "operations"
                rows[(what, dtype_name, k)] = (ms, plain_ms, bound, by)

                def run():
                    tl = verify.timeline_buffer()
                    verify(t, timeline=tl)
                    return tl

                log_stage_times(f"{what} {dtype_name} verify pass K={k} t={t}", verify.stages(t),
                                run, card)
                log(f"[time] {what} {dtype_name} verify pass K={k} n_pos={n_pos} tp={tp} t={t}: "
                    f"kernel {ms * 1e3:.1f} us/pass on the device ({ms * 1e3 / k:.1f} us a "
                    f"position; the B=1 step {step_ms * 1e3:.1f} us), {host:.1f} us of host time "
                    f"per eager call, plain {plain_ms * 1e3:.1f} us/pass (eager), bound "
                    f"{bound * 1e3:.2f} us ({by}, {nbytes / 1e6:.2f} MB) [{card}]")
                del caches, rest, verify
    return rows


def time_spec(cfg, device, synth, card: str) -> dict:
    """``time_verify_passes``, then frames/s of ``Synthesizer.synthesize``
    (B = 1, 400 frames) with K = 4 at tau 0, 1e9 and the default, between
    two runs of the sequential decode (``synth``).  Returns the verify
    kernel's rows by (widths, dtype, K)."""
    import torch

    from transformertts_tpu_torch.infer import Synthesizer
    from transformertts_tpu_torch.ops.decode_step import DecodeVerify

    rows = time_verify_passes(cfg, device, card)

    def frames_per_s(s, what):
        """400 frames, then SPEC_K frames (the set-up and one pass, or
        SPEC_K steps): frames/s and ms a launch of the loop, by difference."""
        s.synthesize(TEXTS[0], max_len=32)  # warm
        walls, launches = [], []
        for n in (SERVE_MAX_LEN, SPEC_K):
            torch.cuda.synchronize()
            s.steps_decoded = 0
            t0 = time.perf_counter()
            s.synthesize(TEXTS[0], max_len=n)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append(s.steps_decoded)
        dt = walls[0]
        loop = (walls[0] - walls[1]) / (launches[0] - launches[1]) * 1e3
        log(f"[time] Synthesizer.synthesize B=1 {what}: {SERVE_MAX_LEN} frames in "
            f"{launches[0]} launches, {dt:.3f} s, {SERVE_MAX_LEN / dt:.0f} frames/s; "
            f"{SPEC_K} frames {walls[1] * 1e3:.1f} ms; the loop {loop:.3f} ms a launch "
            f"[{card}]")
        return SERVE_MAX_LEN / dt

    state = synth.model.state_dict()
    fps = {"sequential": frames_per_s(synth, "sequential")}
    for tau in (0.0, 1e9, cfg.runtime.decode_speculative_tau):
        spec = Synthesizer(spec_config(cfg, SPEC_K, tau), state_dict=state, stats=synth.stats,
                           device=device)
        DecodeVerify.launches_total = 0
        fps[f"tau {tau:g}"] = frames_per_s(spec, f"speculative K={SPEC_K} tau {tau:g}")
        del spec
    fps["sequential again"] = frames_per_s(synth, "sequential, again")
    log(f"[time] frames/s at B=1 by decode: " + ", ".join(f"{k} {v:.0f}" for k, v in fps.items())
        + f" [{card}]")
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
                       ("fused FFN forward", ("ffn_fwd_kernel", "ffn_fwd_tc", "ffn_stage_weights")),
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
    log_mel.launches = log_mel.launches_fft = log_mel.launches_dense = 0
    t0 = time.perf_counter()
    preprocess(pcfg, device=device)
    t_prep = time.perf_counter() - t0
    launches = log_mel.launches_fft
    chunks = -(-N_CLIPS // _DEVICE_MEL_BATCH)
    # the statistics pass and the saving pass both extract, on the FFT kernel
    if device.type == "cuda" and (launches, log_mel.launches_dense) != (2 * chunks, 0):
        raise AssertionError(f"preprocess: {launches} FFT and {log_mel.launches_dense} dense "
                             f"log-mel launches, expected {2 * chunks} and 0")
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
        f"{audio_s / t_prep:.0f} audio-s/s; {launches} log-mel FFT launches for {chunks} chunks of "
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


# ------------------------------------------------------------ trainer path

# the trainer phase's corpus: every clip lands in bucket (128 phonemes, 768
# frames), as bench.py's batches do; the loader drops partial buckets, so a
# corpus spread over many buckets would yield no batch.  192 train clips are
# 3 optimizer steps an epoch at Config()'s 16 x 4; 16 clips form the val split
TRAINER_CLIPS, TRAINER_VAL_CLIPS = 208, 16
TRAINER_SECONDS = (8.3, 8.9)  # 715-767 frames at hop 256
TRAINER_PHONEMES = (97, 128)
# the free-running validation decodes up to this many frames (Config()'s
# 1,500 doubles the host-side MCD-DTW for no check this phase makes)
TRAINER_MAX_LEN = 800


def trainer_texts(n: int) -> list:
    """``n`` texts of two ``TEXTS`` sentences whose phoneme sequences are
    ``TRAINER_PHONEMES`` long under this machine's g2p."""
    import itertools

    from transformertts_tpu_torch.text import G2p, phonemize

    g2p = G2p()
    fits = []
    for a, b in itertools.permutations(TEXTS, 2):
        text = f"{a} {b}"
        if TRAINER_PHONEMES[0] <= len(phonemize(text, g2p)[1]) <= TRAINER_PHONEMES[1]:
            fits.append(text)
    if not fits:
        raise AssertionError(f"no pair of sentences has {TRAINER_PHONEMES} phonemes")
    return [fits[i % len(fits)] for i in range(n)]


def write_trainer_corpus(root, seed: int = 1) -> None:
    from transformertts_tpu_torch.dsp.griffin_lim import write_wav

    rng = np.random.default_rng(seed)
    (root / "wavs").mkdir(parents=True)
    lines = []
    for i, text in enumerate(trainer_texts(TRAINER_CLIPS)):
        audio_id = (f"LJ00{1 + i % 3}-{i:04d}" if i < TRAINER_VAL_CLIPS
                    else f"LJ0{10 + i % 40}-{i:04d}")
        n = int(rng.uniform(*TRAINER_SECONDS) * AUDIO["sample_rate"])
        write_wav(root / "wavs" / f"{audio_id}.wav", clip_signal(rng, n), AUDIO["sample_rate"])
        lines.append(f"{audio_id}|{text}|{text}")
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")


def trainer_config(root, **training):
    """``Config()`` at full width and depth on the phase's corpus.  With no
    teacher-forcing warm-up, epoch 0 trains at p_tf 1 and epoch 1 at 0.5
    (the scheduled-sampling step); a stop threshold above 1 makes every
    free-running validation decode all ``TRAINER_MAX_LEN`` frames, so the
    restored model's decode is compared over as many kernel steps."""
    import dataclasses

    from transformertts_tpu_torch.config import Config

    cfg = Config()
    return cfg.replace(
        path=dataclasses.replace(cfg.path, data=str(root / "LJSpeech-1.1"),
                                 preprocessed=str(root / "preprocessed"),
                                 experiment=str(root / "exp")),
        training=dataclasses.replace(cfg.training, **{
            "num_epochs": 2, "teacher_forcing_warmup_epochs": 0, "ema_decay": 0.99,
            "log_interval": 1, **training}),
        runtime=dataclasses.replace(cfg.runtime, infer_max_len=TRAINER_MAX_LEN,
                                    stop_threshold=2.0))


def reader_times(cfg, card: str) -> None:
    """One epoch of the trainer corpus's train split read by each reader of
    ``BucketedLoader`` alone on this thread, in turns numpy / native /
    native / numpy: the batches must be equal; prints the time per batch."""
    from transformertts_tpu_torch.data import BucketedLoader, LJSpeechDataset

    ds = LJSpeechDataset(cfg.path.preprocessed, "train")
    kw = dict(batch_size=cfg.training.batch_size, phoneme_buckets=cfg.runtime.phoneme_buckets,
              mel_buckets=cfg.runtime.mel_buckets, n_mels=cfg.model.n_mels,
              grad_acc_steps=cfg.training.grad_acc_steps, seed=cfg.training.seed,
              n_threads=cfg.training.num_workers)
    ms, epochs = {"numpy": [], "native": []}, {}
    for reader in ("numpy", "native", "native", "numpy"):
        loader = BucketedLoader(ds, use_native=reader == "native", **kw)
        t0 = time.perf_counter()
        batches = list(loader.epoch(0))
        ms[reader].append(1e3 * (time.perf_counter() - t0) / len(batches))
        if loader.reads[reader] != len(batches) * cfg.training.grad_acc_steps:
            raise AssertionError(f"trainer: the {reader} reader read {loader.reads}")
        epochs.setdefault(reader, batches)
    for a, b in zip(epochs["numpy"], epochs["native"], strict=True):
        for key in a:
            if a[key].dtype != b[key].dtype or a[key].tobytes() != b[key].tobytes():
                raise AssertionError(f"trainer: the native reader's {key} differs from numpy's")
    shape = tuple(epochs["native"][0]["melspec"].shape)
    log(f"[trainer] one epoch of {len(ds)} train clips, {len(epochs['native'])} batches of "
        f"{shape} mels, read and padded on one thread: numpy "
        f"{'/'.join(f'{t:.1f}' for t in ms['numpy'])} ms a batch, native npz reader "
        f"({cfg.training.num_workers} threads) {'/'.join(f'{t:.1f}' for t in ms['native'])} "
        f"ms a batch, equal bytes [{card}]")


def check_native_reads(trainer, epochs: int) -> None:
    """Every batch of ``epochs`` epochs of training and validation was read
    by the native npz reader."""
    k = trainer.cfg.training.grad_acc_steps
    train_reads = epochs * trainer.train_loader.batches_per_epoch() * k
    val_reads = epochs * trainer.val_loader.batches_per_epoch()
    if (trainer.train_loader.reads, trainer.val_loader.reads) != (
            {"native": train_reads, "numpy": 0}, {"native": val_reads, "numpy": 0}):
        raise AssertionError(f"trainer: reads train {trainer.train_loader.reads} val "
                             f"{trainer.val_loader.reads}, wanted {train_reads} / {val_reads} "
                             "by the native reader alone")


def all_launches() -> dict:
    from transformertts_tpu_torch.ops.decode_step import decode_step
    from transformertts_tpu_torch.ops.stft import log_mel

    return {**train_counters(), "decode_b1": decode_step.launches - decode_step.launches_batched,
            "decode_batched": decode_step.launches_batched, "log_mel": log_mel.launches_fft}


def zero_all_launches() -> None:
    from transformertts_tpu_torch.ops.decode_step import decode_step
    from transformertts_tpu_torch.ops.stft import log_mel

    zero_train_counters()
    decode_step.launches = decode_step.launches_batched = 0
    log_mel.launches = log_mel.launches_fft = log_mel.launches_dense = 0


def _equal_tensors(a: dict, b: dict) -> list:
    """Names whose tensors differ (or are missing) between ``a`` and ``b``."""
    import torch

    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or not torch.equal(a[k], b[k]))


def phase_trainer(device, root, card: str) -> dict:
    """The user's path: preprocess -> ``Trainer.fit`` -> checkpoints ->
    resume -> ``cli synthesize --wav``; returns the launches of its kernels
    over preprocessing, fit and the CLI."""
    import json as _json

    import torch

    from transformertts_tpu_torch import cli
    from transformertts_tpu_torch.data.preprocess import preprocess
    from transformertts_tpu_torch.infer.decode import make_decode_fn
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.models.factory import runtime_model_kwargs
    from transformertts_tpu_torch.train import create_train_state
    from transformertts_tpu_torch.train.checkpoint import CheckpointManager, load_eval_weights
    from transformertts_tpu_torch.train.trainer import Trainer
    from transformertts_tpu_torch.utils import plot

    t0 = time.perf_counter()
    write_trainer_corpus(root / "LJSpeech-1.1")
    cfg = trainer_config(root)
    t_write = time.perf_counter() - t0
    launches = {}
    zero_all_launches()
    t0 = time.perf_counter()
    preprocess(cfg, device=device)
    t_prep = time.perf_counter() - t0
    launches["preprocess"] = all_launches()
    reader_times(cfg, card)

    exp = root / "exp" / "run"
    zero_all_launches()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, exp, resume=False, device=device)
    t_build = time.perf_counter() - t0
    result = trainer.fit()
    torch.cuda.synchronize()
    launches["fit"] = fit = all_launches()
    t_fit = time.perf_counter() - t0 - t_build
    on_card = device.type == "cuda"  # only a kernel launch counts
    missing = [k for k in ("flash_fwd", "flash_bwd", "ln_fwd", "ln_bwd", "decode_batched")
               if fit[k] <= 0 and on_card]
    if missing or result["epochs"] != 2:
        raise AssertionError(f"trainer: fit ran {result['epochs']} epochs, launches {fit}")
    check_native_reads(trainer, result["epochs"])
    hist = _json.loads((exp / "history.json").read_text())
    if [h["p_tf"] for h in hist] != [1.0, 0.5]:
        raise AssertionError(f"trainer: p_tf per epoch {[h['p_tf'] for h in hist]}, "
                             "wanted teacher forcing then scheduled sampling")
    log(f"[trainer] corpus of {TRAINER_CLIPS} clips written in {t_write:.1f} s, preprocessed in "
        f"{t_prep:.1f} s ({launches['preprocess']['log_mel']} log-mel launches); Trainer built "
        f"in {t_build:.1f} s, fit {result['epochs']} epochs in {t_fit:.1f} s; plots "
        f"{'written' if plot.available() else 'skipped (no matplotlib)'} [{card}]")
    for h in hist:
        log(f"[trainer] epoch {h['epoch']}: p_tf {h['p_tf']:.2f}, loss {h['total']:.4f}, "
            f"{h['audio_s_per_s']:.0f} audio-s/s, median step {h['step_ms_median']:.1f} ms, "
            f"loader wait {100 * h['loader_wait_share']:.2f} % of the {h['epoch_s']:.2f} s epoch "
            f"({h['loader_wait_first_ms']:.1f} ms for the first batch, "
            f"{1e3 * h['loader_wait_share'] * h['epoch_s'] - h['loader_wait_first_ms']:.1f} ms "
            f"for the later ones), val loss "
            f"{h['val_loss']:.4f} (teacher-forced {h['val_tf_ms']:.1f} ms, free-running "
            f"{h['val_free_ms']:.1f} ms, mcd_dtw {h['val_free_mcd_dtw']:.2f}), checkpoint save "
            f"{h['ckpt_save_ms']:.1f} ms [{card}]")
    log(f"[trainer] kernel launches during fit: {fit}; micro-batches read by the native npz "
        f"reader: {trainer.train_loader.reads['native']} train, "
        f"{trainer.val_loader.reads['native']} val, none by numpy")

    # the last validation's free-running decode against a fresh model
    # restored from the latest checkpoint with its eval params
    last = trainer.last_free_decode
    fresh = TransformerTTS(cfg.model, **runtime_model_kwargs(cfg, device))
    step = load_eval_weights(fresh, cfg, exp / "checkpoints")
    again = make_decode_fn(fresh, cfg, device=device)(last["phoneme"], last["phoneme_lens"])
    same = [k for k in ("pred_melspec", "post_melspec", "pred_stop", "n_frames_per_row")
            if not torch.equal(again[k], last["out"][k])]
    if same or again["n_frames"] != last["out"]["n_frames"]:
        raise AssertionError(f"trainer: the validation decode differs from the restored "
                             f"model's on {same}")
    log(f"[trainer] last validation decode ({len(last['phoneme'])} rows, "
        f"{last['out']['n_frames']} frames) equals the decode of checkpoint {step}'s eval "
        "params bit for bit")

    # every restored tensor equals the saved one
    state = trainer.state
    template = create_train_state(TransformerTTS(cfg.model, **runtime_model_kwargs(cfg, device)),
                                  cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, epoch = CheckpointManager(exp / "checkpoints").restore(template)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    differ = (_equal_tensors(restored.model.state_dict(), state.model.state_dict())
              + _equal_tensors(restored.opt_state["mu"], state.opt_state["mu"])
              + _equal_tensors(restored.opt_state["nu"], state.opt_state["nu"])
              + _equal_tensors(restored.ema_params, state.ema_params))
    if differ or (restored.step, restored.opt_state["count"], epoch) != (
            state.step, state.opt_state["count"], 2):
        raise AssertionError(f"trainer: restore != save on {differ[:5]}")
    n_tensors = len(state.model.state_dict()) + 3 * len(state.opt_state["mu"])
    log(f"[trainer] restore of step {state.step}: {n_tensors} tensors equal to the saved ones "
        f"bit for bit, {restore_ms:.1f} ms [{card}]")
    del trainer, template, restored, fresh

    # resume with one more epoch
    zero_all_launches()
    resumed = Trainer(trainer_config(root, num_epochs=3), exp, resume=True, device=device)
    if resumed.start_epoch != 2:
        raise AssertionError(f"trainer: resume starts at epoch {resumed.start_epoch}, not 2")
    more = resumed.fit()
    check_native_reads(resumed, more["epochs"])
    rows = _json.loads((exp / "history.json").read_text())
    if more["epochs"] != 1 or [h["epoch"] for h in rows] != [0, 1, 2]:
        raise AssertionError(f"trainer: resume trained {more['epochs']} epochs, history "
                             f"{[h['epoch'] for h in rows]}")
    launches["resume"] = all_launches()
    log(f"[trainer] resumed at epoch 2: one epoch, {rows[2]['audio_s_per_s']:.0f} audio-s/s, "
        f"history rows {[h['epoch'] for h in rows]}")
    del resumed

    # cli synthesize --wav on the B = 1 kernel
    zero_all_launches()
    sets = [f"path.preprocessed={cfg.path.preprocessed}",
            f"runtime.infer_max_len={TRAINER_MAX_LEN}", "runtime.stop_threshold=2.0"]
    t0 = time.perf_counter()
    cli.main(["synthesize", "--ckpt", str(exp / "checkpoints"), "--text", TEXTS[0],
              "--out", str(root / "mel.npy"), "--wav", str(root / "out.wav"),
              *[a for s in sets for a in ("--set", s)]])
    t_cli = time.perf_counter() - t0
    launches["cli"] = cli_launches = all_launches()
    with wave.open(str(root / "out.wav")) as w:
        n_samples = w.getnframes()
    if n_samples != (TRAINER_MAX_LEN - 1) * AUDIO["hop_length"] or (
            on_card and cli_launches["decode_b1"] != TRAINER_MAX_LEN):
        raise AssertionError(f"cli synthesize: {n_samples} samples, launches {cli_launches}")
    log(f"[trainer] cli synthesize --wav: {n_samples} samples "
        f"({n_samples / AUDIO['sample_rate']:.2f} s), {cli_launches['decode_b1']} B=1 decode-step "
        f"launches, {t_cli:.1f} s with the model's build [{card}]")
    return launches


PARALLEL_SEED, PARALLEL_TIMED = 7, 2  # weights; timed steps after the checked one
# (1 x 2) + SP against one process, bf16: the loss and the norm relative; a
# gradient (Adam's first moment after one step) as the norm of its error
# against its own norm, with a floor of 1e-3 of the global norm for tensors
# whose true gradient is (near) zero, such as the key-projection biases
PARALLEL_TOL, PARALLEL_GRAD_FLOOR = TRAIN_TOL["bfloat16"][1], 1e-3


def large_tp_config(**runtime):
    """``configs/large_tp.yaml``: d_model 1,024, 16 heads, d_ffn 4,096, 6 + 6
    layers, bf16, guided attention, ``mesh_model: 2``."""
    import dataclasses
    from pathlib import Path

    from transformertts_tpu_torch.config import load_config

    cfg = load_config(Path(__file__).resolve().parent / "configs" / "large_tp.yaml")
    return cfg.replace(runtime=dataclasses.replace(cfg.runtime, **runtime))


def parallel_batch() -> dict:
    """One micro-batch of 16 rows at 768 mel frames and 128 phonemes."""
    return synthetic_batch(np.random.default_rng(21), 1, TRAIN_B)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parallel_run(model, cfg, state, batch, timed: int) -> dict:
    """The checked step (counts from 0), then ``timed`` more: metrics, the
    launches of the checked step, ms per timed step, and the whole tensors."""
    import torch

    from transformertts_tpu_torch.parallel.mesh import gather_state
    from transformertts_tpu_torch.train import make_train_step

    step = make_train_step(model, cfg)
    zero_train_counters()
    state, metrics = step(state, batch, 0.5, torch.Generator().manual_seed(9))
    sync(model.device)
    counts = train_counters()
    whole = gather_state(state)
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "launches": counts,
           "model": {k: v.to("cpu", torch.float32, copy=True) for k, v in whole["model"].items()},
           "mu": {k: v.to("cpu", copy=True) for k, v in whole["mu"].items()}}
    t0 = time.perf_counter()
    for i in range(timed):
        state, _ = step(state, batch, 0.5, torch.Generator().manual_seed(10 + i))
    sync(model.device)
    out["step_ms"] = 1e3 * (time.perf_counter() - t0) / max(timed, 1)
    return out


def _parallel_worker(rank: int, port: int, out_dir: str, device_type: str, cfg, batch) -> None:
    """One of the two processes of the (1 x 2) + SP step on the one card
    (gloo with CUDA tensors: NCCL refuses two ranks on one device)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from transformertts_tpu_torch.parallel import make_mesh, shard_batch, shard_state
    from transformertts_tpu_torch.train import create_train_state

    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime, shard_sequence=True))
        mesh = make_mesh(1, 2)
        model = train_model(cfg, device, seed=PARALLEL_SEED)
        state = shard_state(create_train_state(model, cfg), mesh, shard_sequence=True)
        batch = shard_batch(batch, mesh, shard_sequence=True)
        out = parallel_run(model, cfg, state, batch, PARALLEL_TIMED)
        if rank:
            out = {k: out[k] for k in ("launches", "step_ms")}
        torch.save(out, f"{out_dir}/parallel_{rank}.pt")
    finally:
        dist.destroy_process_group()


def check_parallel(got: dict, ref: dict) -> str:
    """The sharded step against the one-process step; the worst ratios."""
    for name in ("total", "grad_norm", "pred_mel", "post_mel", "stop", "guided_attn"):
        rel = abs(got["metrics"][name] - ref["metrics"][name]) / max(abs(ref["metrics"][name]),
                                                                     1e-12)
        if not rel <= PARALLEL_TOL:
            raise AssertionError(f"parallel: {name} sharded {got['metrics'][name]} != one "
                                 f"process {ref['metrics'][name]} ({rel:.3g} relative)")
    floor = PARALLEL_GRAD_FLOOR * 0.1 * ref["metrics"]["grad_norm"]  # mu = 0.1 * gradient
    worst = (0.0, "")
    for name, want in ref["mu"].items():
        ratio = float((got["mu"][name] - want).norm()) / max(float(want.norm()), floor)
        worst = max(worst, (ratio, name))
        if not ratio <= PARALLEL_TOL:
            raise AssertionError(f"parallel: gradient of {name} off by {ratio:.3g} of its norm")
    p_err = max(rel_err(got["model"][k], v)[1] for k, v in ref["model"].items())
    if not p_err <= PARALLEL_TOL:
        raise AssertionError(f"parallel: a parameter after the step off by {p_err:.3g}")
    return (f"worst gradient {worst[0]:.2e} of its norm ({worst[1]}), parameters and "
            f"BatchNorm statistics after the step within {p_err:.1e}")


def shard_kernel_calls(cfg, batch, rank: int, device) -> dict:
    """The flash and LN calls of model rank ``rank`` of the (1 x 2) + SP
    step of ``cfg`` on ``batch`` at their own shard geometry: 16 x H / 2
    heads over all of T (flash, ``mask_bh = (0, H, rank H / 2)``), T / 2
    local rows of each batch row (LN, ``row_map = (T / 2, T, rank T / 2)``),
    bf16, the layers' dropout rate.  Also the FFN's at ``Config()``'s (2 x
    2) + SP geometry (data rank ``rank``, model rank 1: whole T, half the
    batch rows, d_ffn / 2 columns), since ``large_tp.yaml``'s d_ffn has no
    FFN mask geometry.  name -> (kernel call, plain call), each given the
    mask offsets to use (None: offset 0)."""
    import torch

    from transformertts_tpu_torch.ops import flash_attention as fa
    from transformertts_tpu_torch.ops import fused_ffn as ffn
    from transformertts_tpu_torch.ops import fused_ln as ln

    m, dtype, p = cfg.model, torch.bfloat16, cfg.model.decoder_dropout
    b, t_mel, t_ph = (int(n) for n in batch["melspec"].shape[1:3] + batch["phoneme"].shape[2:3])
    h_total, d = m.decoder_n_head, m.d_model
    h, dh = h_total // 2, d // h_total
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    calls = {}
    shapes = {"enc_self": (t_ph, t_ph, False), "dec_self": (t_mel, t_mel, True),
              "cross": (t_mel, t_ph, False)}
    for name, (tq, tk, causal) in shapes.items():
        q, k, v, dout, bias = attn_inputs(b, h, tq, tk, dh, dtype, device, seed=31 + rank)
        fargs = (dh ** -0.5, causal, p, fa.pick_block(tq, tk))
        shard = (0, h_total, rank * h)
        out, mx, l = fa.flash_forward(q, k, v, bias, 99, *fargs, mask_bh=shard)

        def kern_f(o, q=q, k=k, v=v, bias=bias, fargs=fargs):
            return [fa.flash_forward(q, k, v, bias, 99, *fargs, mask_bh=o)[0]]

        def plain_f(o, q=q, k=k, v=v, bias=bias, fargs=fargs):
            return [tr(fa.flash_attention_reference(tr(q), tr(k), tr(v), bias, 99, *fargs,
                                                    mask_bh=o)[0])]

        def kern_b(o, q=q, k=k, v=v, bias=bias, fargs=fargs, fwd=(out, dout, mx, l)):
            out, dout, mx, l = fwd
            return list(fa.flash_backward(q, k, v, bias, 99, out, dout, mx, l, *fargs,
                                          mask_bh=o))

        def plain_b(o, q=q, k=k, v=v, bias=bias, fargs=fargs, fwd=(out, dout, mx, l)):
            out, dout, mx, l = fwd
            return [tr(g) for g in fa.flash_attention_backward_reference(
                tr(q), tr(k), tr(v), bias, 99, tr(out), tr(dout), mx, l, *fargs, mask_bh=o)]

        what = f"flash {name} B {b} x {h} of {h_total} heads ({tq}, {tk})"
        calls[f"{what} fwd"] = (kern_f, plain_f, shard)
        calls[f"{what} bwd"] = (kern_b, plain_b, shard)
    for name, t in (("decoder", t_mel), ("encoder", t_ph)):
        n, half = b * t // 2, t // 2
        x, hh, g, be, dy = ln_inputs(n, d, dtype, device, seed=41 + rank)
        rows = ln.pick_rows(b * t, d)
        shard = (half, t, rank * half)
        what = f"LN {name} {n} x {d} (mask rows {rows})"
        calls[f"{what} fwd"] = (
            lambda o, a=(x, hh, g, be), r=rows: [ln.fused_ln_forward(*a, 99, p, 1e-5, r,
                                                                     row_map=o)],
            lambda o, a=(x, hh, g, be), r=rows: [ln.residual_dropout_layernorm_reference(
                *a, 99, p, 1e-5, r, row_map=o)],
            shard)
        calls[f"{what} bwd"] = (
            lambda o, a=(x, hh, g, dy), r=rows: list(ln.fused_ln_backward(
                *a, 99, p, 1e-5, r, row_map=o)),
            lambda o, a=(x, hh, g, dy), r=rows: list(
                ln.residual_dropout_layernorm_backward_reference(*a, 99, p, 1e-5, r,
                                                                 row_map=o)),
            shard)
    c = default_config().model
    t, f_total = t_mel, c.decoder_d_ffn
    n, f = b // 2 * t, f_total // 2
    fx, w1, b1, w2, b2, fdy = ffn_inputs(n, c.d_model, f, dtype, device, seed=51 + rank)
    rows = ffn.pick_rows(b * t, c.d_model, f_total, 2)
    shard = ((t, t, rank * n), (f_total, f))
    what = f"FFN Config() {n} x {c.d_model}, d_ffn {f} of {f_total}"

    def ffn_kw(o):
        return {} if o is None else {"row_map": o[0], "col_map": o[1]}

    calls[f"{what} fwd"] = (
        lambda o: [ffn.fused_ffn_forward(fx, w1, b1, w2, b2, 99, p, rows, **ffn_kw(o))],
        lambda o: [ffn.fused_ffn_reference(fx, w1, b1, w2, b2, 99, p, rows, **ffn_kw(o))],
        shard)
    calls[f"{what} bwd"] = (
        lambda o: list(ffn.fused_ffn_backward(fx, w1, b1, w2, fdy, 99, p, rows, **ffn_kw(o))),
        lambda o: list(ffn.fused_ffn_backward_reference(fx, w1, b1, w2, fdy, 99, p, rows,
                                                        **ffn_kw(o))),
        shard)
    return calls


def check_shard_kernels(cfg, batch, device, card: str) -> None:
    """Rows 3-8 at the shard geometry of each rank (``shard_kernel_calls``):
    each kernel against its plain version at the same mask offsets within
    ``TOL``; then, for shard 1, device time per call of the kernel at the
    shard's offsets and at offset 0 in turns (0, offset, offset, 0), and of
    the plain version."""
    import torch

    for rank in (0, 1):
        calls = shard_kernel_calls(cfg, batch, rank, device)
        for what, (kern, plain, shard) in calls.items():
            errs = [rel_err(a, b)[1] for a, b in zip(kern(shard), plain(shard))]
            if not max(errs) <= TOL["bfloat16"]:
                raise AssertionError(f"{what} at shard {rank}'s offsets {shard} != its plain "
                                     f"version: {errs}")
            log(f"[parallel] {what} at shard {rank}'s mask offsets {shard}: kernel vs "
                f"plain, worst relative error {max(errs):.1e}")
        if rank == 1 and device.type == "cuda":
            for what, (kern, plain, shard) in calls.items():
                times = [device_ms(lambda o=o: kern(o), n=10, reps=5)
                         for o in (None, shard, shard, None)]
                plain_ms = time_ms(lambda: plain(shard), 3, warmup=1)
                log(f"[parallel] {what}: kernel at offset 0 / shard 1's offsets / shard 1's "
                    f"offsets / offset 0: " + " / ".join(f"{ms * 1e3:.1f}" for ms in times)
                    + f" us, plain {plain_ms * 1e3:.0f} us [{card}]")
        del calls
        if device.type == "cuda":
            torch.cuda.empty_cache()


def phase_parallel(device, root, card: str, cfg=None, batch=None) -> dict:
    """DP / TP / SP on the card: the ``large_tp.yaml`` step at full width,
    bf16, (1 x 2) + SP in two processes against the one-process step on the
    same inputs; ``entry.dryrun_multichip`` over NCCL on every card; rows
    3-8 at each model rank's shard geometry (``check_shard_kernels``).  Returns the launch counts of the
    sharded step (per rank) and the ms per step."""
    import socket

    import torch
    import torch.multiprocessing as mp

    from transformertts_tpu_torch.entry import dryrun_multichip
    from transformertts_tpu_torch.train import create_train_state

    cfg = cfg or large_tp_config()
    batch = batch or parallel_batch()
    model = train_model(cfg, device, seed=PARALLEL_SEED)
    ref = parallel_run(model, cfg, create_train_state(model, cfg), batch, PARALLEL_TIMED)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_parallel_worker, args=(port, str(root), device.type, cfg, batch),
                       nprocs=2, start_method="spawn")
    runs = [torch.load(root / f"parallel_{r}.pt", weights_only=False) for r in (0, 1)]
    note = check_parallel(runs[0], ref)
    # two forwards and one backward; with guided attention the second
    # forward's cross-attention keeps its weights (the plain path)
    m = cfg.model
    attn = m.encoder_n_layers + m.decoder_n_layers
    ln_calls = 2 * m.encoder_n_layers + 3 * m.decoder_n_layers
    want = {"flash_fwd": 2 * attn + m.decoder_n_layers, "flash_bwd": attn,
            "ln_fwd": 2 * ln_calls, "ln_bwd": ln_calls, "ffn_fwd": 0, "ffn_bwd": 0}
    for r, run in enumerate([ref, *runs]):
        if device.type == "cuda" and run["launches"] != want:
            raise AssertionError(f"parallel {'rank ' + str(r - 1) if r else 'one process'}: "
                                 f"launches {run['launches']}, expected {want}")
    b, t = batch["melspec"].shape[1:3]
    log(f"[parallel] large_tp.yaml (d_model {m.d_model}, {m.encoder_n_head} heads, d_ffn "
        f"{m.encoder_d_ffn}, {m.encoder_n_layers} + {m.decoder_n_layers} layers) "
        f"{cfg.runtime.compute_dtype}, B={b} x {t} frames, (1 x 2) + SP over gloo: loss "
        f"{runs[0]['metrics']['total']:.5f} vs one process {ref['metrics']['total']:.5f}, "
        f"grad_norm {runs[0]['metrics']['grad_norm']:.4f} vs {ref['metrics']['grad_norm']:.4f}; "
        f"{note}; flash / LN launches per rank {runs[0]['launches']} at "
        f"{m.encoder_n_head // 2} heads and {b * t // 2} decoder rows")
    log(f"[time] large_tp.yaml step (1 micro-batch of {b} rows): one process "
        f"{ref['step_ms']:.1f} ms, (1 x 2) + SP ranks {runs[0]['step_ms']:.1f} / "
        f"{runs[1]['step_ms']:.1f} ms (two processes on one card, gloo) [{card}]")
    if device.type == "cuda":
        dryrun_multichip(torch.cuda.device_count())
        check_shard_kernels(cfg, batch, device, card)
    return {"launches": [run["launches"] for run in runs], "ref_ms": ref["step_ms"],
            "step_ms": [run["step_ms"] for run in runs]}


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

    def time_fwd(name, n, d, f):
        """The bf16 forward (staging and kernel) at p and at 0, its plain
        version, bound and library chain; returns the inputs."""
        x, w1, b1, w2, b2, dy = ffn_inputs(n, d, f, dtype, device, seed=n)
        rows_m = ffn.pick_rows(n, d, f, es)
        lw1, lb1, lw2, lb2 = (t.to(dtype) for t in (w1, b1, w2, b2))
        with torch.no_grad():
            lib_f = device_ms(lambda: F.linear(torch.relu(F.linear(x, lw1, lb1)), lw2, lb2))
        f_bound, f_by = bound_ms(2 * n * d * es + 2 * d * f * 4 + (f + d) * 4, 4 * n * d * f,
                                 PEAK_BF16_FLOPS)
        fwd = device_ms(lambda: ffn.fused_ffn_forward(x, w1, b1, w2, b2, 99, p, rows_m),
                        n=10, reps=5)
        report("ffn_fwd", name, fwd,
               time_ms(lambda: ffn.fused_ffn_reference(x, w1, b1, w2, b2, 99, p, rows_m), 5, 2),
               f_bound, f_by, lib_f, f"N={n} D={d} F={f} bf16 p={p}")
        fwd0 = device_ms(lambda: ffn.fused_ffn_forward(x, w1, b1, w2, b2, 99, 0.0, rows_m),
                         n=10, reps=5)
        pl = ffn.fwd_plan(n, d, f)
        log(f"[time] ffn_fwd {name} at p=0: {fwd0 * 1e3:.1f} us (the mask hash and division: "
            f"{100 * (1 - fwd0 / fwd):.0f} % of the p={p} time); plan: clusters of "
            f"{pl['fsplit']}, grid {pl['grid']}, ring of {pl['stages']} [{card}]")
        return x, w1, b1, w2, b2, dy, rows_m

    for name, n in FFN_ROWS.items():
        x, w1, b1, w2, b2, dy, rows_m = time_fwd(name, n, d, f)
        args = (99, p, rows_m)
        lw1, lb1, lw2, lb2 = (t.to(dtype).requires_grad_(True) for t in (w1, b1, w2, b2))
        lx = x.detach().requires_grad_(True)

        def lib_fwd(x_=lx):
            return F.linear(torch.relu(F.linear(x_, lw1, lb1)), lw2, lb2)

        lib_b = device_ms(
            lambda ly: torch.autograd.grad(ly, (lx, lw1, lb1, lw2, lb2), dy, retain_graph=True),
            setup=lib_fwd)
        w_bytes = 2 * d * f * 4  # the fp32 parameters as they lie
        b_bound, b_by = bound_ms(3 * n * d * es + w_bytes + f * 4 + (2 * d * f + f + d) * 4,
                                 10 * n * d * f, PEAK_BF16_FLOPS)
        shape = f"N={n} D={d} F={f} bf16 p={p}"
        bwd = device_ms(lambda: ffn.fused_ffn_backward(x, w1, b1, w2, dy, *args), n=5, reps=5)
        report("ffn_bwd", name, bwd,
               time_ms(lambda: ffn.fused_ffn_backward_reference(x, w1, b1, w2, dy, *args), 5, 2),
               b_bound, b_by, lib_b, shape)
        bwd0 = device_ms(lambda: ffn.fused_ffn_backward(x, w1, b1, w2, dy, 99, 0.0, rows_m),
                         n=5, reps=5)
        log(f"[time] ffn_bwd {name} at p=0: {bwd0 * 1e3:.1f} us (the mask hash: "
            f"{100 * (1 - bwd0 / bwd):.0f} % of the p={p} time) [{card}]")
    # the forward at configs/paper.yaml widths: its training path's two shapes
    # and the kernel phase's odd one
    for name, n in (("paper decoder", FFN_ROWS["decoder"]), ("paper encoder", FFN_ROWS["encoder"]),
                    ("paper N=1000", 1000)):
        time_fwd(name, n, 512, 2048)

    # row 9: the batch preprocess sends (32 clips in one 163,840-sample bucket)
    rng = np.random.default_rng(9)
    clips = [clip_signal(rng, int(n)) for n in rng.integers(44100, MEL_BUCKET_LEN - 1024, MEL_BATCH)]
    y = torch.from_numpy(padded_batch(clips, MEL_BUCKET_LEN)).to(device)
    a = AUDIO
    key = (a["sample_rate"], a["n_fft"], a["win_length"], a["n_mels"], a["fmin"], a["fmax"], device)
    consts, fft_consts = stft._constants(*key), stft._fft_constants(*key)
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
    ops = frames * stft.fft_kernel_operations(n_fft, int(np.count_nonzero(basis)), a["n_mels"])
    log(f"[time] log_mel batch: {nbytes / 1e6:.1f} MB and {flops / 1e9:.2f} GFLOP by an FFT; "
        f"the FFT kernel's schedule does {ops / 1e9:.2f} GFLOP, the dense kernel's DFT products "
        f"{dense_flops / 1e9:.1f} GFLOP ({dense_flops / PEAK_FP32_FLOPS * 1e6:.0f} us at the fp32 peak)")
    plain = time_ms(lambda: stft.log_mel_reference(y, n_frames, *consts, hop), 3, 1)
    note = f"B={MEL_BATCH} n={MEL_BUCKET_LEN} center=False fp32, {frames} frames"
    report("log_mel", "batch",
           device_ms(lambda: stft.log_mel_fft_forward(y, n_frames, *fft_consts, hop), n=4, reps=3),
           plain, bound, by, None, f"FFT kernel, {note}")
    report("log_mel", "batch, dense kernel",
           device_ms(lambda: stft.log_mel_forward(y, n_frames, *consts, hop), n=4, reps=3),
           plain, bound, by, None, f"dense kernel, {note}")
    # no single PyTorch call computes the log-mel; this chain of library calls
    # (cuFFT, a matrix product, two elementwise ops) is printed for scale only
    window, melt = consts[0], consts[3]
    chain = device_ms(lambda: torch.log(torch.clamp(
        torch.stft(y, n_fft, hop, n_fft, window, center=False, return_complex=True).abs()
        .transpose(1, 2) @ melt, min=stft.CLIP)), n=4, reps=3)
    log(f"[time] log_mel batch: the chain torch.stft().abs() -> matmul -> clamp -> log takes "
        f"{chain * 1e3:.1f} us [{card}]")
    return rows


# ------------------------------------------------------------------ Tacotron 2

T2_TP, T2_STEPS, T2_SERVE_LEN = 192, 32, 576
# kernel vs tacotron2_step_reference, each output and state over T2_STEPS
# steps, max|kernel - plain| / max(1, max|plain|): both take the same bf16
# operands and sum in fp32 in other orders, and the recurrence carries it
# (the H100 showed at most 3.4e-4); a stage that computes the wrong thing
# moves its own output by far more
T2_TOL = 2e-3
T2_STATES = ("p1", "p", "q", "energy", "alpha", "alpha_cum", "ctx", "c1", "c2", "y")


def tacotron2_setup(b: int, device, seed: int = 2**31 + 99):
    """Tacotron 2 at NVIDIA's widths (``portbench/configs/tacotron2.json``),
    bf16, seeded weights, prenet dropout 0.5, and b rows of ragged phoneme ids
    padded to ``T2_TP`` (row 0 full)."""
    import torch

    from portbench import harness
    from portbench.reference.tacotron2_weights import make_weights
    from transformertts_tpu_torch.models.tacotron2 import Tacotron2

    conf = harness.config_spec("tacotron2")
    cfg = harness.program_config(conf, {"infer_max_len": T2_SERVE_LEN, "stop_threshold": 2.0})
    weights = make_weights(conf["model"], seed, device)
    model = Tacotron2(cfg.model, dtype=torch.bfloat16, device=device)
    model.load_state_dict(weights, strict=True)
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(T2_TP // 2, T2_TP + 1, (b,), generator=gen)
    lens[0] = T2_TP
    ids = torch.where(torch.arange(T2_TP)[None] < lens[:, None],
                      torch.randint(4, 84, (b, T2_TP), generator=gen), 0)
    return conf, cfg, weights, model, ids.to(device), lens.to(device)


def t2_gaps(kern, plain, t: int) -> dict:
    """Each output and state of one step, kernel against plain."""
    import torch

    out = {}
    for name in T2_STATES + ("h1", "h2"):
        a, r = getattr(kern, name), getattr(plain, name)
        if name in ("h1", "h2"):  # double-buffered: the half this step wrote
            a, r = a[(t + 1) & 1], r[(t + 1) & 1]
        if name == "energy":  # padded positions are -inf in both
            a, r = torch.nan_to_num(a, neginf=0.0), torch.nan_to_num(r, neginf=0.0)
        out[name] = rel_err(a, r)[1]
    return out


def t2_one_launch_a_call(call, n: int = 64) -> None:
    """``n`` calls ``call(t)`` under ``torch.profiler`` (device activity
    only: the step's cooperative launch is no PyTorch operation a host
    event could hold) launch no kernel but ``tacotron2_step``'s, and at
    most ``n``: at most one a call (at least one a call: each call's state
    moved, which the gap check reads).  A profiling session after others in
    one process may miss its first few launches (the full run's profiler
    recorded 14 of 16, an earlier one 0 of 1; alone 16 of 16), so the
    count is a ceiling, not an equality."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(n):
            call(t)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not any(w in e.name.lower() for w in ("memcpy", "memset"))]
    if not 0 < len(kernels) <= n or not all("tacotron2_step" in k for k in kernels):
        raise AssertionError(f"{n} calls launched {len(kernels)} kernels: {kernels[:30]}")
    log(f"[tacotron2] {n} calls under the profiler: {len(kernels)} launches recorded, all of "
        f"{kernels[0][:80]}")


def phase_tacotron2(device, card: str) -> dict:
    """The Tacotron 2 step kernel at NVIDIA's widths on its path's shapes
    (B 1 and 8, Tp 192, prenet dropout 0.5): against its plain version,
    timed beside it and its bound, and its launches on the main path."""
    import torch

    from portbench import counts_tacotron2
    from transformertts_tpu_torch.infer import DynamicBatcher, Synthesizer
    from transformertts_tpu_torch.infer.decode import make_decode_fn
    from transformertts_tpu_torch.ops.tacotron2_step import (
        Tacotron2State,
        Tacotron2Step,
        pack_tacotron2_weights,
        tacotron2_step_reference,
    )

    seed = 1234 ^ 0x5EED  # the decode's mask seed at training.seed 1234
    drop = dict(prenet_dropout=PRENET_DROPOUT, seed=seed)
    worst, rows = {}, {}
    with torch.no_grad():
        for b in (1, 8):
            conf, cfg, _, model, ids, lens = tacotron2_setup(b, device)
            memory = model.encode(ids, lens)
            pm = model.process_memory(memory)
            packed = pack_tacotron2_weights(model)
            lens32 = lens.int()
            kern_state = Tacotron2State(packed, b, T2_TP, device)
            plain_state = Tacotron2State(packed, b, T2_TP, device)
            step = Tacotron2Step(memory, pm, lens32, packed, kern_state)
            frame = torch.zeros((b, cfg.model.n_mels), device=device)
            frames, gaps = [frame], {}
            for t in range(T2_STEPS):  # both from their own state, fed the kernel's frames
                y = step(t, frames[-1], **drop)
                tacotron2_step_reference(t, frames[-1], plain_state, memory, pm, lens32, packed,
                                         **drop)
                for name, g in t2_gaps(kern_state, plain_state, t).items():
                    gaps[name] = max(gaps.get(name, 0.0), g)
                frames.append(y[:, : cfg.model.n_mels].clone(memory_format=torch.contiguous_format))
            ys = torch.stack(frames[1:])
            again = Tacotron2State(packed, b, T2_TP, device)
            step2 = Tacotron2Step(memory, pm, lens32, packed, again)
            ys2 = torch.stack([step2(t, frames[t], **drop)[:, : cfg.model.n_mels].clone()
                               for t in range(T2_STEPS)])
            log(f"[tacotron2] B={b} Tp={T2_TP} {T2_STEPS} steps, prenet dropout "
                f"{PRENET_DROPOUT}: widest gap to the plain version by output "
                + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
            bad = {k: v for k, v in gaps.items() if not v <= T2_TOL}
            if bad:
                raise AssertionError(f"tacotron2_step B={b} beyond {T2_TOL}: {bad}")
            if not torch.equal(ys, ys2):
                raise AssertionError(f"tacotron2_step B={b}: a second run gave other bits")
            worst[b] = max(gaps.values())
            if b == 8:
                t2_one_launch_a_call(lambda t: step(t, frames[-1], **drop))

            state = Tacotron2State(packed, b, T2_TP, device)
            timed = Tacotron2Step(memory, pm, lens32, packed, state)
            kern = lambda: timed(7, frame, **drop)  # noqa: E731
            plain = lambda: tacotron2_step_reference(  # noqa: E731
                7, frame, state, memory, pm, lens32, packed, **drop)
            ms, host = time_ms(kern, 200, 10), host_us(kern)
            plain_ms = time_ms(plain, 20, 3)
            nbytes, flops = counts_tacotron2.step_bytes_flops(conf["model"], b, T2_TP)
            bound, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
            rows[b] = (ms, plain_ms, bound, by)
            log(f"[time] tacotron2_step bf16 B={b} Tp={T2_TP}, prenet dropout {PRENET_DROPOUT}: "
                f"kernel {ms * 1e3:.1f} us/step back to back ({host:.1f} us of host time a "
                f"call), plain {plain_ms * 1e3:.1f} us/step, bound {bound * 1e3:.2f} us ({by}, "
                f"{nbytes / 1e6:.2f} MB) [{card}]")
            del model, memory, pm, packed, step, step2, timed

    # the main path: DynamicBatcher -> Synthesizer -> kernel loop, then a stream
    conf, cfg, weights, model, _, _ = tacotron2_setup(1, device)
    del model
    synth = Synthesizer(cfg, state_dict=weights, stats=dict(conf["stats"]), device=device)
    batcher = DynamicBatcher(synth, max_batch=8, max_wait_ms=50.0, max_len=T2_SERVE_LEN)
    try:
        Tacotron2Step.total = synth.steps_decoded = 0
        with ThreadPoolExecutor(12) as pool:
            mels = list(pool.map(lambda txt: batcher.submit(txt).result(timeout=300), TEXTS[:12]))
        launches, steps = Tacotron2Step.total, synth.steps_decoded
    finally:
        batcher.close()
    if any(m.shape != (cfg.model.n_mels, T2_SERVE_LEN) or not np.isfinite(m).all()
           for m in mels):
        raise AssertionError("bad mel from the Tacotron 2 batcher")
    Tacotron2Step.total = 0
    chunks = list(synth.stream(TEXTS[0], chunk=STREAM_CHUNK, max_len=T2_SERVE_LEN))
    launches_stream = Tacotron2Step.total
    log(f"[tacotron2] DynamicBatcher, 12 requests of {T2_SERVE_LEN} frames: {launches} kernel "
        f"launches for {steps} decode steps; Synthesizer.stream, {len(chunks)} chunks: "
        f"{launches_stream} launches")
    if launches != steps or launches < T2_SERVE_LEN or launches_stream != T2_SERVE_LEN:
        raise AssertionError("Tacotron 2 serving did not launch the step kernel once a step")
    conf, cfg, _, model, ids, lens = tacotron2_setup(8, device)
    with torch.no_grad():
        check_late_readback(
            "tacotron2", lambda th: make_decode_fn(model, cfg, max_len=LATE_STEPS,
                                                   stop_threshold=th, device=device)(ids, lens),
            lambda: Tacotron2Step.total, "tacotron2_step", card)
    return {"worst": worst, "rows": rows, "launches": launches,
            "launches_stream": launches_stream}


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
    t2 = phase_tacotron2(device, card) if "tacotron2" in phases else {}
    stream_launches = {}
    if "stream" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
            stream_launches = phase_stream(device, Path(tmp), card)
    spec = {}
    if "spec" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_spec_") as tmp:
            spec = phase_spec(cfg, device, Path(tmp), card)
    launches, rows, drop_rows, spec_rows = {}, {}, {}, {}
    if phases & {"serve", "time"}:
        scfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime, stop_threshold=2.0))
        gen_model = make_model(scfg, torch.bfloat16, "cpu", seed=5)
        synth = Synthesizer(scfg, state_dict=gen_model.state_dict(),
                            stats={"mean": -5.0, "std": 2.0}, device=device)
        if "serve" in phases:
            launches = phase_serve(scfg, device, synth, cfg.runtime.stop_threshold)
        if "time" in phases:
            rows, drop_rows = phase_time(scfg, device, synth, card)
            spec_rows = time_spec(scfg, device, synth, card)
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
    trainer = {}
    if "trainer" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
            trainer = phase_trainer(device, Path(tmp), card)
    parallel = {}
    if "parallel" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
            parallel = phase_parallel(device, Path(tmp), card)
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
    # launches of each kernel on the trainer path: preprocessing, fit (train
    # steps, validation and its free-running decode), the resumed epoch and
    # cli synthesize, each counted from 0
    on_trainer = {key: sum(run[key] for run in trainer.values())
                  for key in ("flash_fwd", "flash_bwd", "ln_fwd", "ln_bwd", "ffn_fwd", "ffn_bwd",
                              "decode_b1", "decode_batched", "log_mel")}
    for b, name, line, key in ((1, "decode_step", 300, "b1"),
                               (8, "decode_step_batched", 532, "batched")):
        ms, plain, bound, by = rows[("Config()", b, SERVE_MAX_LEN, 64, 200)]
        kernels.append({
            "name": f"{name} (B={b}, bf16, n_pos {SERVE_MAX_LEN}, Tp 64, t 200)",
            "route": "cuda", "source": src + "decode_step.cu",
            "replaces": f"{pallas}decode_step.py:{line}",
            "launches": launches[key], "max_abs_err": worst[b],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "launches_trainer": on_trainer[f"decode_{key}"],
            "launches_stream": stream_launches[key],
            "ms_prenet_dropout": drop_rows[b][1],
            "shapes": {f"{what} n_pos {n_pos} Tp {tp} t {t}": dict(
                zip(("ms", "plain_ms", "bound_ms", "bound_by"), r))
                for (what, rb, n_pos, tp, t), r in rows.items() if rb == b},
        })
    # row 1's verify form on the speculative path (B = 1, K = 4)
    ms, plain, bound, by = spec_rows[("Config()", "bfloat16", SPEC_K)]
    kernels.append({
        "name": f"decode_step_verify (K={SPEC_K}, bf16, n_pos {SERVE_MAX_LEN}, Tp 64, t 200)",
        "route": "cuda", "source": src + "decode_step_verify.cu",
        "replaces": f"{pallas}decode_step.py:300",
        "verifies": "transformertts_tpu/infer/decode.py:307",
        "launches": spec["launches"], "max_abs_err": max(spec["worst"].values()),
        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shapes": {f"{what} {dtype} K {k}": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), r))
                   for (what, dtype, k), r in spec_rows.items()},
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
             "FFT kernel, B=32 n=163840 center=False, fp32")):
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
            "launches_trainer": on_trainer[count or "log_mel"],
            # the (1 x 2) + SP step of large_tp.yaml, both ranks
            "launches_parallel": sum(r[count] for r in parallel["launches"]) if count else 0,
            "shapes": {shape: dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"), r))
                       for (kern, shape), r in train_rows.items() if kern == kernel},
        })
    # T2: Tacotron 2's step, on its serving path (it replaces no TPU kernel)
    ms, plain, bound, by = t2["rows"][8]
    kernels.append({
        "name": f"tacotron2_step (B=8, bf16, Tp {T2_TP}, prenet dropout {PRENET_DROPOUT})",
        "route": "cuda", "source": src + "tacotron2_step.cu", "replaces": None,
        "launches": t2["launches"], "max_abs_err": max(t2["worst"].values()),
        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": None,
        "launches_stream": t2["launches_stream"],
        "shapes": {f"B {b} Tp {T2_TP}": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), r))
                   for b, r in t2["rows"].items()},
    })
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError("a kernel of the path was launched no time on the main path")
    if any(k["launches_trainer"] <= 0 for k in kernels
           if "ffn" not in k["name"] and "verify" not in k["name"]
           and not k["name"].startswith("tacotron2")):
        raise AssertionError("a kernel of the trainer path was launched no time on it")
    if any(k.get("launches_stream", 1) <= 0 for k in kernels):
        raise AssertionError("the decode step was launched no time on the streaming path")
    if any(k.get("launches_parallel", 1) <= 0 for k in kernels if k["name"][:3] in ("fla", "ln_")):
        raise AssertionError("flash or LN was launched no time on the sharded path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
