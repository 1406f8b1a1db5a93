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


def torch_state_from_jax(variables, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """flax variables of ``transformertts_tpu.models.TransformerTTS(cfg)`` ->
    fp32 CPU ``state_dict`` for ``TransformerTTS(cfg)`` of this package."""
    expected = {
        k: tuple(v.shape)
        for k, v in TransformerTTS(cfg, device="meta").state_dict().items()
    }
    state: dict[str, torch.Tensor] = {}
    for collection, names in (("params", _PARAM_LEAF), ("batch_stats", _STATS_LEAF)):
        for path, arr in _flatten(variables.get(collection, {})):
            leaf = path[-1]
            if leaf not in names:
                raise ValueError(f"unused leaf {collection}/{'/'.join(path)}")
            key = ".".join(path[:-1] + (names[leaf],))
            if leaf == "kernel":
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
            if key not in expected or tuple(arr.shape) != expected[key]:
                raise ValueError(
                    f"unused leaf {collection}/{'/'.join(path)} "
                    f"(shape {arr.shape}) -> {key}"
                )
            state[key] = torch.tensor(np.asarray(arr, np.float32))
    for collection in variables:
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unused collection {collection!r}")
    missing = sorted(set(expected) - set(state))
    if missing:
        raise ValueError(f"missing leaves for {missing}")
    return state
