"""Checkpoint save/restore of a ``TrainState`` (``transformertts_tpu/train/checkpoint.py``).

The JAX package writes orbax checkpoints; this package writes its own
format, one directory per optimizer step:

    <directory>/<step>/state.pt   torch.save of {"model": state_dict
                                  (parameters and BatchNorm statistics),
                                  "opt": {"count", "mu", "nu"}, "step",
                                  "ema_params": {name: tensor} or None}
    <directory>/<step>/meta.json  {"format", "step", "epoch", "has_ema", **extra}

A save writes both files into ``.tmp-<step>`` and renames the directory
into place, so an interrupted save leaves no step directory and the
previous latest intact; a step directory without ``meta.json`` (written
last) is not a checkpoint.  ``max_to_keep`` keeps the newest steps.
Whether a save carries an EMA copy is recorded in ``meta.json``
(``has_ema``), the format's own metadata.

A sharded state (``parallel.shard_state``) is saved whole: every rank
gathers its model group's parts (``parallel.mesh.gather_state``), rank 0
alone writes, and every rank then waits at a barrier (as the JAX package's
``checkpoint.py``).  ``restore`` reads the whole tensors on every rank and
takes this rank's parts, so a checkpoint restores on any mesh.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from transformertts_tpu_torch.parallel.mesh import gather_state, param_spec, shard_tensor

log = logging.getLogger("transformertts_tpu_torch.checkpoint")

FORMAT = "transformertts_tpu_torch/1"
_STATE, _META = "state.pt", "meta.json"


def is_orbax_directory(directory: str | Path) -> bool:
    """Whether ``directory`` holds checkpoints written by the JAX package
    (orbax step directories)."""
    base = Path(directory)
    if not base.is_dir():
        return False
    for sub in base.iterdir():
        if sub.name.isdigit() and sub.is_dir() and (
                (sub / "_CHECKPOINT_METADATA").exists() or (sub / "default").is_dir()):
            return True
    return False


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def all_steps(self) -> list[int]:
        """Steps of the complete checkpoints, ascending."""
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.name.isdigit() and (p / _META).is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, epoch: int, extra: Optional[dict] = None) -> None:
        """Write ``state`` (a ``train_step.TrainState``) as checkpoint ``step``;
        ``epoch`` is the next epoch to train."""
        step = int(step)
        whole = gather_state(state)
        mesh = state.model.layout.mesh
        if mesh.size > 1:
            if mesh.rank == 0:
                self._write(step, state, epoch, extra, whole)
            dist.barrier(group=mesh.group)
        else:
            self._write(step, state, epoch, extra, whole)

    def _write(self, step: int, state, epoch: int, extra, whole: dict) -> None:
        tmp = self._dir / f".tmp-{step}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save({
            "model": whole["model"],
            "opt": {"count": int(state.opt_state["count"]), "mu": whole["mu"], "nu": whole["nu"]},
            "step": int(state.step),
            "ema_params": whole["ema"],
        }, tmp / _STATE)
        meta = {"format": FORMAT, "step": step, "epoch": int(epoch),
                "has_ema": state.ema_params is not None, **(extra or {})}
        (tmp / _META).write_text(json.dumps(meta))
        final = self._dir / str(step)
        if final.exists():  # re-saving a step replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._dir / str(old), ignore_errors=True)

    def restore(self, state_template, step: Optional[int] = None, adopt_ema: bool = True):
        """Load checkpoint ``step`` (default: the latest) into
        ``state_template`` in place; returns (state, epoch), or (None, 0)
        when there is no checkpoint.  Tensors are loaded onto the device of
        the template's model.

        EMA, as in the JAX package: a template that keeps an EMA copy while
        the checkpoint has none warm-starts it from a COPY of the restored
        parameters; a checkpoint's EMA that the template does not keep is
        adopted when ``adopt_ema`` (evaluation: ``eval_params`` then serve
        it) and dropped otherwise (resumed EMA-off training keeps its
        layout).  A sharded template takes this rank's parts."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, 0
        path = self._dir / str(step)
        meta = json.loads((path / _META).read_text())
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path} is not a checkpoint of this package: {meta.get('format')!r}")
        state = state_template
        device = state.model.device
        payload = torch.load(path / _STATE, map_location=device, weights_only=True)
        mesh = state.model.layout.mesh
        tp = mesh.n_model > 1

        def local(tree):
            if tree is None or not tp:
                return tree
            return {k: shard_tensor(v, param_spec(k, tp), mesh) for k, v in tree.items()}

        state.model.load_state_dict(local(payload["model"]), strict=True)
        params = dict(state.model.named_parameters())
        opt = {**payload["opt"], "mu": local(payload["opt"]["mu"]),
               "nu": local(payload["opt"]["nu"])}
        for key in ("mu", "nu"):
            if set(opt[key]) != set(params):
                raise ValueError(f"{path}: optimizer {key} does not match the model's parameters")
        state.opt_state = {"count": int(opt["count"]), "mu": opt["mu"], "nu": opt["nu"]}
        state.step = int(payload["step"])
        disk_ema = local(payload["ema_params"])
        if meta["has_ema"] != (disk_ema is not None):
            raise ValueError(f"{path}: meta.json and state.pt disagree on the EMA copy")
        if state.ema_params is not None and disk_ema is None:
            log.info("checkpoint has no EMA; warm-starting ema_params from params")
            state.ema_params = {k: p.detach().clone() for k, p in params.items()}
        elif state.ema_params is None and disk_ema is not None:
            if adopt_ema:
                log.info("checkpoint carries EMA params; restoring them for eval")
                state.ema_params = disk_ema
            else:
                log.info("checkpoint carries EMA params; dropping for EMA-off training")
        else:
            state.ema_params = disk_ema
        if state.ema_params is not None and set(state.ema_params) != set(params):
            raise ValueError(f"{path}: ema_params do not match the model's parameters")
        epoch = int(meta["epoch"])
        log.info("restored checkpoint step=%d epoch=%d from %s", step, epoch, self._dir)
        return state, epoch

    def close(self) -> None:
        """Saves are synchronous: nothing is left to flush."""


def load_eval_weights(model, cfg, directory: str | Path, step: Optional[int] = None) -> int:
    """Load checkpoint ``step`` (default: the latest) of ``directory`` into
    ``model`` for inference: its ``eval_params`` (the EMA copy when the
    checkpoint carries one) and BatchNorm statistics.  Returns the step.

    A missing directory or one without a checkpoint raises
    ``FileNotFoundError``; an orbax directory of the JAX package raises
    ``NotImplementedError`` naming the converter, ``tools/orbax_to_torch.py``."""
    from transformertts_tpu_torch.train.train_step import create_train_state

    directory = Path(directory)
    if not directory.is_dir():
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    if is_orbax_directory(directory):
        raise NotImplementedError(
            f"{directory} holds orbax checkpoints of the JAX package; convert them into this "
            f"package's format with `python tools/orbax_to_torch.py {directory} DST` where JAX "
            "is installed (ROADMAP Queue 1 item 5)")
    mgr = CheckpointManager(directory)
    step = step if step is not None else mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    state, _ = mgr.restore(create_train_state(model, cfg), step, adopt_ema=True)
    with torch.no_grad():
        model.load_state_dict({**model.state_dict(), **state.eval_params}, strict=True)
    return step
