"""Weight bridge: the JAX package's flax variables -> this package's state.

``torch_state_from_jax`` takes ``{"params": ..., "batch_stats": ...}`` as
nested dicts of numpy arrays (``jax.device_get`` of the flax tree) and
returns the ``state_dict`` of ``models.tts.TransformerTTS``.  The torch
modules carry the flax names, so a flax path maps onto a state key by
joining it with dots and renaming the leaf:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in), transposed;
- Conv ``kernel`` (k, in, out) -> ``weight`` (out, in, k);
- LayerNorm / BatchNorm ``scale`` -> ``weight``; Embed ``embedding`` ->
  ``weight``; ``bias`` and the (1,)-shaped PE ``alpha`` keep their names;
- ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
  (flax's biased variance, used as it is).

A leaf that maps onto no key of the model, a shape that disagrees, or a key
of the model that no leaf fills, raises ``ValueError``.

``torch_tree_from_jax`` maps ANY params-shaped flax tree (gradients, Adam's
``mu`` / ``nu``) onto this package's parameter names with the same
transposes, and ``opt_state_from_optax`` builds this package's optimizer
state from the optax state's moments and count, so that a test can start
both packages from the same mid-training state.
"""

from __future__ import annotations

import numpy as np
import torch

from transformertts_tpu_torch.config import ModelConfig
from transformertts_tpu_torch.models.tts import TransformerTTS

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias", "alpha": "alpha"}
_STATS_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    if hasattr(tree, "items"):  # dict or flax FrozenDict
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def _map_collection(tree, names: dict, expected: dict, what: str) -> dict[str, torch.Tensor]:
    """One flax collection -> {state key: fp32 CPU tensor}, checked against
    the ``expected`` shapes."""
    state: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree):
        leaf = path[-1]
        if leaf not in names:
            raise ValueError(f"unused leaf {what}/{'/'.join(path)}")
        key = ".".join(path[:-1] + (names[leaf],))
        if leaf == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
        if key not in expected or tuple(arr.shape) != expected[key]:
            raise ValueError(
                f"unused leaf {what}/{'/'.join(path)} (shape {arr.shape}) -> {key}")
        state[key] = torch.tensor(np.asarray(arr, np.float32))
    return state


def _check_complete(state: dict, expected) -> None:
    missing = sorted(set(expected) - set(state))
    if missing:
        raise ValueError(f"missing leaves for {missing}")


def torch_state_from_jax(variables, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """flax variables of ``transformertts_tpu.models.TransformerTTS(cfg)`` ->
    fp32 CPU ``state_dict`` for ``TransformerTTS(cfg)`` of this package."""
    expected = {
        k: tuple(v.shape)
        for k, v in TransformerTTS(cfg, device="meta").state_dict().items()
    }
    state: dict[str, torch.Tensor] = {}
    for collection, names in (("params", _PARAM_LEAF), ("batch_stats", _STATS_LEAF)):
        state.update(_map_collection(variables.get(collection, {}), names, expected, collection))
    for collection in variables:
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unused collection {collection!r}")
    _check_complete(state, expected)
    return state


def torch_tree_from_jax(tree, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """A params-shaped flax tree (the parameters themselves, their gradients,
    an Adam moment) -> {parameter name: fp32 CPU tensor} in this package's
    layouts; every parameter of the model must be present."""
    expected = {
        k: tuple(v.shape)
        for k, v in TransformerTTS(cfg, device="meta").named_parameters()
    }
    state = _map_collection(tree, _PARAM_LEAF, expected, "params")
    _check_complete(state, expected)
    return state


def opt_state_from_optax(mu, nu, count, cfg: ModelConfig, device="cpu") -> dict:
    """This package's optimizer state (``train_step.AdamNoam``) from the
    moments and the count of optax's ``ScaleByAdamState`` (as numpy trees and
    an int; the schedule's count equals Adam's)."""
    return {
        "count": int(count),
        "mu": {k: v.to(device) for k, v in torch_tree_from_jax(mu, cfg).items()},
        "nu": {k: v.to(device) for k, v in torch_tree_from_jax(nu, cfg).items()},
    }
