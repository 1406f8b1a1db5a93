"""Command-line entry points of the port (``transformertts_tpu/cli.py``).

  python -m transformertts_tpu_torch.cli train --config config.yaml
  python -m transformertts_tpu_torch.cli preprocess --config config.yaml
  python -m transformertts_tpu_torch.cli synthesize --ckpt DIR --text "..." [--wav out.wav]
  python -m transformertts_tpu_torch.cli serve --ckpt DIR [--wav] [--input lines.txt]
  python -m transformertts_tpu_torch.cli serve-http --ckpt DIR

Every verb runs on the GPU unless ``--device cpu`` names the CPU.
``train --distributed`` (or ``TTS_DISTRIBUTED`` set) trains one process per
device over the mesh of ``runtime.mesh_data`` / ``mesh_model``, started by
torchrun (``torchrun --nproc-per-node N -m transformertts_tpu_torch.cli
train --distributed ...``): NCCL with ``cuda:LOCAL_RANK``, or gloo with
``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys


def _add_common(p):
    p.add_argument("--config", default=None, help="YAML config path (defaults = reference config)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   help="dotted override, e.g. training.batch_size=32")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs on the CPU)")


def _init_distributed(device) -> None:
    """``init_process_group`` from torchrun's environment: NCCL on
    ``cuda:LOCAL_RANK``, gloo when the device is the CPU."""
    import os

    import torch
    import torch.distributed as dist

    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        sys.exit(f"train --distributed takes its processes from torchrun's environment; "
                 f"{', '.join(missing)} unset (start it with torchrun --nproc-per-node N)")
    if device is not None and str(device).startswith("cpu"):
        dist.init_process_group("gloo")
    else:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")


def cmd_train(args):
    import os

    distributed = args.distributed or bool(os.environ.get("TTS_DISTRIBUTED"))
    if distributed:
        _init_distributed(args.device)
    try:
        _train(args)
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args) -> None:
    import torch.distributed as dist

    from transformertts_tpu_torch.config import load_config
    from transformertts_tpu_torch.train.trainer import Trainer
    from transformertts_tpu_torch.utils import increment_path

    cfg = load_config(args.config, args.overrides)
    exp_dir = args.exp_dir
    if exp_dir is None:  # one run directory, picked by rank 0, for every rank
        box = [increment_path(cfg.path.experiment)
               if not dist.is_initialized() or dist.get_rank() == 0 else None]
        if dist.is_initialized():
            dist.broadcast_object_list(box, src=0)
        exp_dir = box[0]
    trainer = Trainer(cfg, exp_dir, resume=not args.no_resume,
                      profile_steps=args.profile_steps, device=args.device)
    result = trainer.fit()
    if not trainer.rank0:
        return
    if result["epochs"] == 0:
        print("nothing to do: training already completed (resume found "
              f"epoch {trainer.start_epoch} >= num_epochs)")
    else:
        print(f"done: best val loss {result['best_val']:.4f} after {result['epochs']} epochs")


def cmd_preprocess(args):
    import logging

    from transformertts_tpu_torch.config import load_config
    from transformertts_tpu_torch.data.preprocess import preprocess

    logging.basicConfig(level=logging.INFO, format="%(levelname)s | %(message)s")
    preprocess(load_config(args.config, args.overrides), device=args.device)


def _synthesizer(cfg, args):
    from transformertts_tpu_torch.infer import Synthesizer

    try:
        return Synthesizer(cfg, checkpoint_dir=args.ckpt, device=args.device)
    except FileNotFoundError as e:
        sys.exit(f"no checkpoint found: {e}")


def cmd_synthesize(args):
    """Text -> mel (and wav) as the JAX CLI decodes it: an fp32 model with
    the checkpoint's eval weights, the phonemes padded to the largest
    bucket, the mel cut at the decode's global frame count."""
    import numpy as np
    import torch

    from transformertts_tpu_torch.config import load_config
    from transformertts_tpu_torch.data.dataset import load_stats
    from transformertts_tpu_torch.device import resolve_device
    from transformertts_tpu_torch.dsp import denormalize_mel
    from transformertts_tpu_torch.dsp.griffin_lim import griffin_lim, write_wav
    from transformertts_tpu_torch.infer.decode import make_decode_fn
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.text import G2p, phonemize
    from transformertts_tpu_torch.train.checkpoint import load_eval_weights

    cfg = load_config(args.config, args.overrides)
    device = resolve_device(args.device)
    model = TransformerTTS(cfg.model, dtype=torch.float32, device=device)
    try:
        load_eval_weights(model, cfg, args.ckpt)
    except FileNotFoundError as e:
        sys.exit(f"no checkpoint found: {e}")
    _, seq = phonemize(args.text, G2p())
    max_p = cfg.runtime.phoneme_buckets[-1]
    phoneme = np.zeros((1, max_p), np.int32)
    phoneme[0, : min(len(seq), max_p)] = seq[:max_p]
    out = make_decode_fn(model, cfg, device=device)(phoneme, np.array([len(seq)], np.int32))
    mel = out["post_melspec"][0, : out["n_frames"]].cpu().numpy()  # (T, n_mels)
    if cfg.audio.normalize_mel:
        try:
            stats = load_stats(cfg.path.preprocessed)
            mel = denormalize_mel(mel, stats["mean"], stats["std"])
        except FileNotFoundError:
            print("warning: stats.json not found; mel left normalized")
    np.save(args.out, mel.T)  # (n_mels, T), the layout preprocess writes
    print(f"wrote {mel.shape[0]} frames to {args.out}")
    if args.wav:
        a = cfg.audio
        y = griffin_lim(torch.from_numpy(np.ascontiguousarray(mel.T)).to(device),
                        a.sample_rate, a.n_fft, a.hop_length, a.win_length, a.fmin, a.fmax)
        write_wav(args.wav, y, a.sample_rate)
        print(f"wrote {len(y) / a.sample_rate:.2f}s of audio to {args.wav}")


def cmd_serve(args):
    """Piped serving loop: each non-empty line of text in (stdin, or
    ``--input``) -> ``utt_NNNN.npy`` (and ``.wav``) out, decoded chunk by
    chunk through ``Synthesizer.stream``."""
    from pathlib import Path

    import numpy as np

    from transformertts_tpu_torch.config import load_config
    from transformertts_tpu_torch.dsp.griffin_lim import write_wav

    cfg = load_config(args.config, args.overrides)
    synth = _synthesizer(cfg, args)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    src = open(args.input, encoding="utf-8") if args.input else sys.stdin
    try:
        for line in src:
            text = line.strip()
            if not text:
                continue
            chunks = []
            for chunk in synth.stream(text, chunk=args.chunk):
                chunks.append(chunk)
                print(f"\r[{n}] {sum(c.shape[1] for c in chunks)} frames", end="",
                      file=sys.stderr)
            print(file=sys.stderr)
            mel = (np.concatenate(chunks, axis=1) if chunks
                   else np.zeros((cfg.model.n_mels, 0), np.float32))
            path = out_dir / f"utt_{n:04d}"
            np.save(f"{path}.npy", mel)
            if args.wav:
                write_wav(f"{path}.wav", synth.mel_to_wav(mel), cfg.audio.sample_rate)
            print(f"[{n}] {mel.shape[1]} frames -> {path}.npy" + (" + .wav" if args.wav else ""))
            n += 1
    finally:
        if args.input:
            src.close()
    print(f"served {n} utterances")


def cmd_serve_http(args):
    """Dynamic-batching HTTP synthesis server: concurrent POSTs coalesce
    into one padded decode batch (infer/serving.py)."""
    import signal
    import threading

    from transformertts_tpu_torch.config import load_config
    from transformertts_tpu_torch.infer import DynamicBatcher, make_http_server

    cfg = load_config(args.config, args.overrides)
    synth = _synthesizer(cfg, args)
    if args.warmup:
        sizes = sorted({1, args.max_batch})
        print(f"warming the decode (batch sizes {sizes} x "
              f"{len(cfg.runtime.phoneme_buckets)} buckets)...", flush=True)
        print(f"warmed {synth.warmup(batch_sizes=tuple(sizes))} decodes", flush=True)
    batcher = DynamicBatcher(synth, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    server = make_http_server(batcher, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  "
          f"(max_batch={args.max_batch}, max_wait_ms={args.max_wait_ms})", flush=True)
    # serve on a side thread and park on an event: SIGTERM and SIGINT both
    # release it for a graceful drain and a stats print
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except (ValueError, OSError):  # not the main thread
            pass
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        print(f"stats: {batcher.stats()}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="transformertts_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", help="train the model")
    _add_common(p_train)
    p_train.add_argument("--exp-dir", default=None)
    p_train.add_argument("--no-resume", action="store_true")
    p_train.add_argument("--distributed", action="store_true",
                         help="one process per device, started by torchrun (also with "
                              "TTS_DISTRIBUTED set): NCCL, or gloo with --device cpu")
    p_train.add_argument("--profile-steps", type=int, default=0,
                         help="write a torch.profiler trace of N steps to <exp-dir>/profile")
    p_train.set_defaults(fn=cmd_train)

    p_pre = sub.add_parser("preprocess", help="offline feature extraction")
    _add_common(p_pre)
    p_pre.set_defaults(fn=cmd_preprocess)

    p_syn = sub.add_parser("synthesize", help="text -> mel with a trained checkpoint")
    _add_common(p_syn)
    p_syn.add_argument("--ckpt", required=True, help="checkpoint directory")
    p_syn.add_argument("--text", required=True)
    p_syn.add_argument("--out", default="mel.npy")
    p_syn.add_argument("--wav", default=None, help="also write audio via Griffin-Lim inversion")
    p_syn.set_defaults(fn=cmd_synthesize)

    p_srv = sub.add_parser("serve", help="stream-synthesize each stdin line")
    _add_common(p_srv)
    p_srv.add_argument("--ckpt", required=True, help="checkpoint directory")
    p_srv.add_argument("--out-dir", default="served")
    p_srv.add_argument("--chunk", type=int, default=64)
    p_srv.add_argument("--wav", action="store_true",
                       help="also write Griffin-Lim audio per utterance")
    p_srv.add_argument("--input", default=None,
                       help="read lines from a file instead of stdin")
    p_srv.set_defaults(fn=cmd_serve)

    p_http = sub.add_parser("serve-http", help="dynamic-batching HTTP synthesis server")
    _add_common(p_http)
    p_http.add_argument("--ckpt", required=True, help="checkpoint directory")
    p_http.add_argument("--host", default="127.0.0.1")
    p_http.add_argument("--port", type=int, default=8777)
    p_http.add_argument("--max-batch", type=int, default=8,
                        help="coalesce up to N concurrent requests per decode")
    p_http.add_argument("--max-wait-ms", type=float, default=20.0,
                        help="max extra latency to wait for batch fill")
    p_http.add_argument("--warmup", action="store_true",
                        help="one decode per batch size {1, max_batch} x phoneme bucket "
                             "before accepting requests (builds and loads the kernels)")
    p_http.set_defaults(fn=cmd_serve_http)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
