"""Does the loader hold ``Trainer.fit``'s step back?  On the card.

    python3 probes/trainer_loader.py [--turns 12]

Needs one Hopper GPU, nvcc and a host C++ compiler.  Builds the kernels,
writes and preprocesses ``chip_smoke.py``'s trainer corpus with 512 train
clips (8 optimizer steps an epoch at ``Config()``'s 16 x 4, every clip in
bucket (128, 768)), and trains epochs with ``Trainer.train_epoch`` (no
validation) in turns:

- ``loader``: as ``fit`` does, ``prefetch(loader.epoch(e))``: a thread reads
  and pads the next batches while the step runs, reading with numpy
  (``use_native=False``);
- ``native loader``: the same, reading with the threaded C++ npz reader
  (``use_native`` left at ``"auto"``, as ``Trainer`` builds it: the probe
  fails unless that is the native reader);
- ``in memory``: the same batches read beforehand, so the prefetch thread
  only hands them over.

The turns go loader / native loader / in memory / in memory / native loader
/ loader, and again.  Each prints the median and spread of the step's host
time, the time blocked in ``next()`` (first batch apart) and audio-s/s, with
the card's name and power limit; before the turns, for each reader, its
time per batch to read and pad an epoch alone on this thread and
``batch_to_device``'s.  The difference between a loader turn and an in
memory one is what the loader's work costs the step.  PERF.md quotes its
output.
"""

import argparse
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

here = Path(__file__).resolve().parent
sys.path.insert(0, str(here.parent))
import chip_smoke as cs  # noqa: E402
from transformertts_tpu_torch import _build  # noqa: E402
from transformertts_tpu_torch.data import BucketedLoader  # noqa: E402
from transformertts_tpu_torch.data.prefetch import batch_to_device  # noqa: E402
from transformertts_tpu_torch.data.preprocess import preprocess  # noqa: E402
from transformertts_tpu_torch.train import trainer as trainer_module  # noqa: E402

TRAIN_CLIPS = 512


def timed_epoch(trainer, epoch: int, batches=None) -> dict:
    """One ``train_epoch``; with ``batches``, the loader's epoch is replaced
    by that list.  Returns the step times and the waits in ``next()``."""
    steps, waits = [], []
    real_prefetch = trainer_module.prefetch

    def recording_prefetch(iterable, depth=2):
        it = real_prefetch(batches if batches is not None else iterable, depth)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            waits.append(time.perf_counter() - t0)
            yield item

    real_tf, real_ss = trainer.train_step_tf, trainer.train_step_ss
    real_step = real_tf if epoch == 0 else real_ss

    def recording_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(*args)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        return out

    trainer_module.prefetch = recording_prefetch
    trainer.train_step_tf = trainer.train_step_ss = recording_step
    try:
        row = trainer.train_epoch(epoch)
    finally:
        trainer_module.prefetch = real_prefetch
        trainer.train_step_tf, trainer.train_step_ss = real_tf, real_ss
    return {"steps": steps, "waits": waits, "row": row}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=12,
                    help="epochs, in turns loader / native loader / in memory / in memory / "
                         "native loader / loader")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trainer_loader: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    cs.TRAINER_CLIPS = cs.TRAINER_VAL_CLIPS + TRAIN_CLIPS
    with tempfile.TemporaryDirectory(prefix="trainer_loader_") as tmp:
        root = Path(tmp)
        cs.write_trainer_corpus(root / "LJSpeech-1.1")
        cfg = cs.trainer_config(root, num_epochs=2 * args.turns)
        preprocess(cfg, device=device)
        trainer = trainer_module.Trainer(cfg, root / "exp", resume=False, device=device)
        native = trainer.train_loader
        if native.reader != "native":
            raise AssertionError(f"Trainer's loader reads with {native.reader}")
        numpy_loader = BucketedLoader(
            native.ds, native.batch_size, native.pb, native.mb, n_mels=native.n_mels,
            grad_acc_steps=native.k, shuffle=native.shuffle, drop_last=native.drop_last,
            seed=native.seed, use_native=False)
        loaders = {"loader": numpy_loader, "native loader": native}
        n = native.batches_per_epoch()

        for kind in ("loader", "native loader", "native loader", "loader"):
            loader, reads = loaders[kind], []
            real_read = loader._read

            def timed_read(*a, real_read=real_read, reads=reads):
                t0 = time.perf_counter()
                out = real_read(*a)
                reads.append(time.perf_counter() - t0)
                return out

            loader._read = timed_read  # the files alone, without the sort and the stack
            t0 = time.perf_counter()
            batches = list(loader.epoch(0))
            read_s = (time.perf_counter() - t0) / n
            del loader._read
            t0 = time.perf_counter()
            for b in batches:
                batch_to_device(b, device)
            torch.cuda.synchronize()
            copy_s = (time.perf_counter() - t0) / n
            print(f"[{kind}] {n} batches an epoch of {tuple(batches[0]['melspec'].shape)} mels "
                  f"read by {loader.reader}: {1e3 * read_s:.1f} ms a batch to read and pad on "
                  f"this thread alone ({1e3 * sum(reads) / n:.1f} ms of it reading the files "
                  f"into padded rows), {1e3 * copy_s:.1f} ms a batch through "
                  f"batch_to_device [{card}]", flush=True)

        timed_epoch(trainer, 0)  # warm: first calls, cuBLAS, allocator
        cycle = ["loader", "native loader", "in memory", "in memory", "native loader", "loader"]
        kinds = cycle * (args.turns // len(cycle) + 1)
        for turn, kind in enumerate(kinds[:args.turns]):
            epoch = 1 + turn  # scheduled-sampling epochs (p_tf < 1)
            mem = list(native.epoch(epoch)) if kind == "in memory" else None
            trainer.train_loader = loaders.get(kind, native)
            r = timed_epoch(trainer, epoch, mem)
            steps = sorted(1e3 * s for s in r["steps"])
            waits = [1e3 * w for w in r["waits"]]
            print(f"[turn {turn}] {kind}: epoch {epoch} p_tf {r['row']['p_tf']:.2f}, step "
                  f"median {statistics.median(steps):.1f} ms (min {steps[0]:.1f}, max "
                  f"{steps[-1]:.1f}) over {len(steps)} steps, blocked in next() "
                  f"{waits[0]:.1f} ms for the first batch and {sum(waits[1:]):.1f} ms for "
                  f"the other {len(waits) - 1}, {r['row']['audio_s_per_s']:.0f} audio-s/s "
                  f"[{card}]", flush=True)
        if numpy_loader.reads["native"] or native.reads["numpy"]:
            raise AssertionError(f"reads: numpy loader {numpy_loader.reads}, native loader "
                                 f"{native.reads}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
