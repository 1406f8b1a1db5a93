"""Command-line entry points of the port (``transformertts_tpu/cli.py``).

  python -m transformertts_tpu_torch.cli train --config config.yaml
  python -m transformertts_tpu_torch.cli preprocess --config config.yaml
  python -m transformertts_tpu_torch.cli synthesize --ckpt DIR --text "..." [--wav out.wav]
  python -m transformertts_tpu_torch.cli serve-http --ckpt DIR

Every verb runs on the GPU unless ``--device cpu`` names the CPU.  Not
ported yet: the streaming ``serve`` verb (ROADMAP Queue 1 item 2) and
multi-process training (``train --distributed``, item 6); both raise.
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


def cmd_train(args):
    from transformertts_tpu_torch.config import load_config
    from transformertts_tpu_torch.train.trainer import Trainer
    from transformertts_tpu_torch.utils import increment_path

    if args.distributed:
        raise NotImplementedError(
            "multi-process training is not ported yet (ROADMAP Queue 1 item 6, parallel/mesh.py)")
    cfg = load_config(args.config, args.overrides)
    exp_dir = args.exp_dir or increment_path(cfg.path.experiment)
    trainer = Trainer(cfg, exp_dir, resume=not args.no_resume,
                      profile_steps=args.profile_steps, device=args.device)
    result = trainer.fit()
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
    import numpy as np

    from transformertts_tpu_torch.config import load_config
    from transformertts_tpu_torch.dsp.griffin_lim import write_wav

    cfg = load_config(args.config, args.overrides)
    synth = _synthesizer(cfg, args)
    if cfg.audio.normalize_mel and synth.stats is None:
        print("warning: stats.json not found; mel left normalized")
    mel = synth.synthesize(args.text)[0]  # (n_mels, T), the layout preprocess writes
    np.save(args.out, mel)
    print(f"wrote {mel.shape[1]} frames to {args.out}")
    if args.wav:
        y = synth.mel_to_wav(mel)
        write_wav(args.wav, y, cfg.audio.sample_rate)
        print(f"wrote {len(y) / cfg.audio.sample_rate:.2f}s of audio to {args.wav}")


def cmd_serve(args):
    raise NotImplementedError(
        "the streaming serve verb needs infer/streaming.py, not ported yet "
        "(ROADMAP Queue 1 item 2); serve-http serves whole utterances")


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
                         help="multi-process training (not ported yet: raises)")
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

    p_srv = sub.add_parser("serve", help="stream-synthesize each stdin line (not ported yet)")
    _add_common(p_srv)
    p_srv.add_argument("--ckpt", required=True, help="checkpoint directory")
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
