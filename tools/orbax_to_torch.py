"""Converts an orbax checkpoint of the JAX package into the PyTorch port's format.

    python tools/orbax_to_torch.py SRC DST [--step N] [--config YAML] [--set k=v ...]

SRC is a checkpoint directory written by ``transformertts_tpu``'s trainer
(``train/checkpoint.py:CheckpointManager``, orbax); DST receives one step
directory in ``transformertts_tpu_torch``'s format (``train/checkpoint.py``
there), which ``Synthesizer(checkpoint_dir=DST)``, ``cli synthesize`` /
``serve`` and ``Trainer(resume=True)`` of the port read.  ``--config`` and
``--set`` name the model the checkpoint was trained with (default: the
reference config), ``--step`` the step (default: the latest).

The tool builds the JAX ``TrainState`` template at the config's shapes and
restores through the JAX ``CheckpointManager.restore`` as it stands, so
every checkpoint generation it reads (EMA copy, none, or absent) is read.
It writes the parameters and BatchNorm statistics
(``convert.torch_state_from_jax``), Adam's moments and count
(``convert.opt_state_from_optax``; a flattened ``runtime.fused_optimizer``
state is unflattened first), the step, the epoch, and the EMA copy or its
absence.  A tree that does not fit the config's model is refused.  It runs
where JAX and orbax are installed, on the CPU; the port itself never
imports JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _adam_state(opt_state):
    """The ``optax.ScaleByAdamState`` inside an optax state tree."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu") and hasattr(opt_state, "count"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def _unflatten_like(params, flat):
    """A flat vector (``optax.flatten``'s layout) as a tree shaped like
    ``params``."""
    import jax
    import numpy as np

    leaves, treedef = jax.tree.flatten(params)
    flat = np.asarray(flat)
    sizes = [int(np.size(x)) for x in leaves]
    if flat.ndim != 1 or flat.size != sum(sizes):
        raise ValueError(f"a flat optimizer moment of {flat.size} values does not fit the "
                         f"{sum(sizes)} parameters of the model")
    parts = np.split(flat, np.cumsum(sizes)[:-1])
    return jax.tree.unflatten(treedef, [p.reshape(np.shape(x)) for p, x in zip(parts, leaves)])


def convert(src, dst, config=None, overrides=(), step=None) -> tuple[int, int]:
    """Convert checkpoint ``step`` (default: the latest) of the orbax
    directory ``src`` into the port's format under ``dst``; returns
    (step, epoch).  Raises ``FileNotFoundError`` without a checkpoint and
    ``ValueError`` for a tree that does not fit the config's model."""
    import jax
    import numpy as np

    from transformertts_tpu.config import load_config as jax_load_config
    from transformertts_tpu.models import TransformerTTS as JaxTTS
    from transformertts_tpu.train.checkpoint import CheckpointManager as OrbaxManager
    from transformertts_tpu.train.train_step import create_train_state as jax_train_state
    from transformertts_tpu_torch.config import load_config
    from transformertts_tpu_torch.convert import (
        opt_state_from_optax,
        torch_state_from_jax,
        torch_tree_from_jax,
    )
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.train.checkpoint import CheckpointManager
    from transformertts_tpu_torch.train.train_step import create_train_state

    overrides = list(overrides)
    jcfg, cfg = jax_load_config(config, overrides), load_config(config, overrides)
    src = Path(src)
    if not src.is_dir():
        raise FileNotFoundError(f"no checkpoint directory {src}")
    n_mels = jcfg.model.n_mels
    example = {
        "phoneme": np.zeros((1, 1, 16), np.int32),
        "melspec": np.zeros((1, 1, 32, n_mels), np.float32),
        "phoneme_lens": np.full((1, 1), 16, np.int32),
        "melspec_lens": np.full((1, 1), 32, np.int32),
    }
    # a template without an EMA copy, restored with adopt_ema: the state
    # then carries the checkpoint's EMA copy exactly when the checkpoint has one
    template = jax_train_state(JaxTTS(jcfg.model), jcfg, jax.random.PRNGKey(0), example)
    template = template.replace(ema_params=None)
    mgr = OrbaxManager(src)
    try:
        state, epoch = mgr.restore(template, step, adopt_ema=True)
    finally:
        mgr.close()
    if state is None:
        raise FileNotFoundError(f"no checkpoint in {src}")
    state = jax.device_get(state)

    model = TransformerTTS(cfg.model, device="cpu")
    model.load_state_dict(torch_state_from_jax(
        {"params": state.params, "batch_stats": state.batch_stats}, cfg.model), strict=True)
    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("the checkpoint's optimizer state holds no Adam moments")
    mu, nu = adam.mu, adam.nu
    if np.ndim(mu) == 1 and not hasattr(mu, "items"):  # runtime.fused_optimizer
        mu, nu = _unflatten_like(state.params, mu), _unflatten_like(state.params, nu)
    out = create_train_state(model, cfg)
    out.opt_state = opt_state_from_optax(mu, nu, int(np.asarray(adam.count)), cfg.model)
    out.step = int(np.asarray(state.step))
    out.ema_params = (torch_tree_from_jax(state.ema_params, cfg.model)
                      if state.ema_params is not None else None)
    CheckpointManager(dst).save(out.step, out, epoch, extra={"converted_from": "orbax"})
    return out.step, epoch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src", help="orbax checkpoint directory of the JAX package")
    ap.add_argument("dst", help="directory for the port's checkpoint")
    ap.add_argument("--step", type=int, default=None, help="step to convert (default: latest)")
    ap.add_argument("--config", default=None, help="YAML config the checkpoint was trained with")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="dotted override, e.g. model.d_model=512")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")  # a conversion needs no accelerator
    try:
        step, epoch = convert(args.src, args.dst, args.config, args.overrides, args.step)
    except FileNotFoundError as e:
        print(f"orbax_to_torch: {e}", file=sys.stderr)
        return 1
    print(f"converted step {step} (epoch {epoch}) of {args.src} into {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
