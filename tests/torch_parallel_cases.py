"""The sharded cases that ``tests/test_torch_parallel.py`` runs in one group
of spawned gloo workers (a module of its own, so the workers import torch
and the port only).

Every worker calls ``run(rank, world, port, out_dir, plan)``: for each round
of the plan it builds every case's mesh (``make_mesh`` is called by all
workers, in one order) and runs the cases whose ranks hold it, side by side;
each rank saves its case's result as ``<out_dir>/<case>_<mesh rank>.pt``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from transformertts_tpu_torch import cli
from transformertts_tpu_torch.config import tiny_config
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.models.factory import runtime_model_kwargs
from transformertts_tpu_torch.models.modules import DropoutRng
from transformertts_tpu_torch.parallel import collectives, make_mesh, shard_batch, shard_state
from transformertts_tpu_torch.parallel.mesh import gather_state
from transformertts_tpu_torch.train import create_train_state, make_train_step
from transformertts_tpu_torch.train.checkpoint import CheckpointManager

P_TF = 0.8


def config(guided: float = 1.0, ffn: bool = False, ema: float = 0.0):
    """``tiny_config`` in fp32 (flash and fused LN on: their plain versions
    on the CPU), guided attention, dropout as configured."""
    cfg = tiny_config()
    return cfg.replace(
        loss=dataclasses.replace(cfg.loss, guided_attn_weight=guided),
        runtime=dataclasses.replace(cfg.runtime, use_pallas_fused_ffn=ffn),
        training=dataclasses.replace(cfg.training, ema_decay=ema)).validate()


def batch(seed: int, k: int = 2, b: int = 4, tp: int = 16, tm: int = 64, n_mels: int = 80):
    """A global (K, B, ...) batch with ragged lengths (one row full)."""
    rng = np.random.default_rng(seed)
    p_lens = rng.integers(tp // 2, tp + 1, (k, b)).astype(np.int32)
    m_lens = rng.integers(tm // 2, tm + 1, (k, b)).astype(np.int32)
    p_lens[:, 0], m_lens[:, 0] = tp, tm
    phoneme = rng.integers(1, 60, (k, b, tp)).astype(np.int32)
    phoneme[np.arange(tp)[None, None] >= p_lens[..., None]] = 0
    return {"phoneme": phoneme,
            "melspec": rng.standard_normal((k, b, tm, n_mels)).astype(np.float32),
            "phoneme_lens": p_lens, "melspec_lens": m_lens}


def model(cfg):
    return TransformerTTS(cfg.model, generator=torch.Generator().manual_seed(0),
                          **runtime_model_kwargs(cfg, "cpu"))


def result(state, metrics) -> dict:
    """What a step leaves, as whole tensors (a collective on a mesh)."""
    whole = gather_state(state)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "step": state.step,
            **{k: v for k, v in whole.items()}}


def one_process_step(cfg, data: dict, scheduled_sampling: bool = True) -> dict:
    m = model(cfg)
    state = create_train_state(m, cfg)
    step = make_train_step(m, cfg, scheduled_sampling=scheduled_sampling)
    state, metrics = step(state, data, P_TF, torch.Generator().manual_seed(1))
    return result(state, metrics)


def sharded_step(cfg, data: dict, mesh, sp: bool, scheduled_sampling: bool = True,
                 restore=None, save=None, weights=None, p_tf: float = P_TF) -> dict:
    m = model(cfg)
    if weights is not None:  # a state dict of whole tensors
        m.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    state = shard_state(create_train_state(m, cfg), mesh, sp)
    if restore is not None:
        state, _ = CheckpointManager(restore).restore(state)
    step = make_train_step(m, cfg, scheduled_sampling=scheduled_sampling)
    collectives.reset_counts()
    state, metrics = step(state, shard_batch(data, mesh, shard_sequence=sp), p_tf,
                          torch.Generator().manual_seed(1))
    counts = dict(collectives.COUNTS)
    out = {**result(state, metrics), "counts": counts}
    if save is not None:
        CheckpointManager(save).save(state.step, state, epoch=1)
    return out


def forward_counts(cfg, data: dict, mesh, sp: bool) -> dict:
    """The collectives of one train-mode forward (alignments on) and of
    its backward."""
    m = model(cfg)
    shard_state(create_train_state(m, cfg), mesh, sp)
    micro = {k: v[0] for k, v in shard_batch(data, mesh, shard_sequence=sp).items()}
    collectives.reset_counts()
    out = m(micro["phoneme"], micro["melspec"].float(), micro["phoneme_lens"].long(),
            micro["melspec_lens"].long(), train=True, rng=DropoutRng(3))
    fwd = dict(collectives.COUNTS)
    collectives.reset_counts()
    (out["post_melspec"].sum() + out["alignments"].sum()).backward()
    return {"forward": fwd, "backward": dict(collectives.COUNTS)}


def run_case(case: dict, mesh) -> dict:
    """``case["config"]`` / ``case["data"]``, when given, replace the
    config and batch made from ``cfg`` / ``seed``."""
    cfg = case.get("config") or config(**case.get("cfg", {}))
    data = case.get("data") or batch(case.get("seed", 0))
    if case.get("poison_rank") is not None:  # non-finite rows on one data rank only
        rows = data["melspec"].shape[1] // mesh.n_data
        r0 = case["poison_rank"] * rows
        data["melspec"][:, r0:r0 + rows, 3] = np.nan
    if case["kind"] == "forward":
        return forward_counts(cfg, data, mesh, case["sp"])
    return sharded_step(cfg, data, mesh, case["sp"], restore=case.get("restore"),
                        save=case.get("save"), weights=case.get("weights"),
                        p_tf=case.get("p_tf", P_TF))


def run(rank: int, world: int, port: int, out_dir: str, plan: list, cli_args: dict,
        cli_port: int) -> None:
    """``plan``: rounds, each a list of cases {"name", "mesh": (n_data,
    n_model), "ranks", "sp", "kind": "step" | "forward", "cfg", ...}.  Then,
    with the group torn down, ranks 0 and 1 run ``cli train --distributed``
    as torchrun would start it (``cli_args["dist"]``) and rank 2 the
    one-process ``cli train`` (``cli_args["one"]``), each into
    ``<out_dir>/exp/<dist | one>``, stdout into ``<out_dir>/cli_<rank>.log``."""
    torch.set_num_threads(1)  # the workers share the host with the test run's others
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        for cases in plan:
            meshes = [make_mesh(*c["mesh"], ranks=c["ranks"]) for c in cases]
            for case, mesh in zip(cases, meshes):
                if mesh is not None:
                    torch.save(run_case(case, mesh), f"{out_dir}/{case['name']}_{mesh.rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank > 2:
        return
    run_dir = "dist" if rank < 2 else "one"
    argv = ["train", "--device", "cpu", "--exp-dir", f"{out_dir}/exp/{run_dir}",
            *[a for o in cli_args[run_dir] for a in ("--set", o)]]
    if rank < 2:
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                          MASTER_ADDR="localhost", MASTER_PORT=str(cli_port))
        argv.append("--distributed")
    with open(f"{out_dir}/cli_{rank}.log", "w") as log, contextlib.redirect_stdout(log):
        cli.main(argv)
