"""Entry points of the port for an outside harness that checks a model (the
counterpart of the JAX package's ``__graft_entry__.py``).

- ``entry(device=None)``: the eval-mode teacher-forced forward of the
  flagship model (``Config()``, the reference-parity LJSpeech model) and an
  example batch of 16 rows, 128 phonemes and 512 mel frames, on the GPU
  unless the caller names another device.
- ``dryrun_multichip(n, device=None)``: one sharded training step of
  ``tiny_config`` over n processes, one a device (NCCL on the GPUs, or gloo
  with ``device="cpu"``): a mesh of n / 2 data x 2 model ranks with
  sequence parallelism when n >= 4 is even, else n data ranks; a finite
  loss and step 1, or it raises.
"""

from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from transformertts_tpu_torch.config import Config
from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.models import TransformerTTS


def entry(device: str | torch.device | None = None):
    """Returns (fn, example_args): ``fn(*example_args)`` is the forward's
    dict of ``pred_melspec`` / ``pred_stop`` / ``post_melspec`` /
    ``alignments``."""
    device = resolve_device(device)
    cfg = Config().validate()
    dtype = torch.bfloat16 if cfg.runtime.compute_dtype == "bfloat16" else torch.float32
    model = TransformerTTS(cfg.model, dtype=dtype, device=device)
    b, tp, tm = 16, 128, 512
    rng = np.random.default_rng(0)
    phoneme = torch.from_numpy(rng.integers(1, 60, (b, tp))).to(device)
    melspec = torch.from_numpy(
        rng.standard_normal((b, tm, cfg.model.n_mels)).astype(np.float32)).to(device)
    p_lens = torch.full((b,), tp, dtype=torch.long, device=device)
    m_lens = torch.full((b,), tm, dtype=torch.long, device=device)

    @torch.inference_mode()
    def forward(phoneme, melspec, p_lens, m_lens):
        return model(phoneme, melspec, p_lens, m_lens)

    return forward, (phoneme, melspec, p_lens, m_lens)


def _example_batch(rng, k: int, b: int, tp: int, tm: int, n_mels: int) -> dict:
    return {
        "phoneme": rng.integers(1, 60, (k, b, tp)).astype(np.int32),
        "melspec": rng.standard_normal((k, b, tm, n_mels)).astype(np.float32),
        "phoneme_lens": rng.integers(tp // 2, tp + 1, (k, b)).astype(np.int32),
        "melspec_lens": rng.integers(tm // 2, tm + 1, (k, b)).astype(np.int32),
    }


def _dryrun_worker(rank: int, n: int, port: int, device_type: str) -> None:
    from transformertts_tpu_torch.config import tiny_config
    from transformertts_tpu_torch.models.factory import runtime_model_kwargs
    from transformertts_tpu_torch.parallel import make_mesh, shard_batch, shard_state
    from transformertts_tpu_torch.train import create_train_state, make_train_step

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:  # n processes share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", world_size=n, rank=rank)
    try:
        n_model = 2 if n % 2 == 0 and n >= 4 else 1
        n_data = n // n_model
        mesh = make_mesh(n_data, n_model)
        sp = n_model > 1  # DP + TP + SP (Megatron layout), as the JAX dry run
        cfg = tiny_config()
        device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
        model = TransformerTTS(cfg.model, generator=torch.Generator().manual_seed(0),
                               **runtime_model_kwargs(cfg, device))
        state = shard_state(create_train_state(model, cfg), mesh, shard_sequence=sp)
        batch = _example_batch(np.random.default_rng(0), k=2, b=2 * n_data, tp=16, tm=64,
                               n_mels=cfg.model.n_mels)
        step = make_train_step(model, cfg, scheduled_sampling=True)
        state, metrics = step(state, shard_batch(batch, mesh, shard_sequence=sp), 0.8,
                              torch.Generator().manual_seed(1))
        total = float(metrics["total"])
        if not np.isfinite(total) or state.step != 1:
            raise RuntimeError(f"dryrun_multichip({n}): loss {total}, step {state.step}")
        if rank == 0:
            print(f"dryrun_multichip({n}): mesh=({n_data} data x {n_model} model"
                  f"{' + seq-parallel' if sp else ''}) over {dist.get_backend()} "
                  f"loss={total:.4f} OK", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> None:
    """One sharded training step over ``n_devices`` processes (see the
    module docstring); raises when a process fails."""
    device_type = resolve_device(device).type
    if device_type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) on {torch.cuda.device_count()} GPUs")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_dryrun_worker, args=(n_devices, port, device_type), nprocs=n_devices,
                       start_method="spawn")
