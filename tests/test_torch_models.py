"""PyTorch port vs JAX package: model forward at tiny widths.

The same numpy-seeded inputs and the same weights (flax init with every
bias, norm parameter and BatchNorm statistic perturbed, carried over by
``transformertts_tpu_torch.convert``) go through the JAX
``TransformerTTS.apply(..., train=False)`` and the port's eval forward.

Tolerances, as max|port - jax| <= tol * max(1, max|jax|):
- fp32: 1e-5 (same math; only the summation order differs);
- bf16: 5e-2 (both round activations to bf16, but at places the two
  frameworks' kernels choose, so single roundings differ by one bf16 ulp,
  2^-8 relative, and compound over ~20 layers).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformertts_tpu.config import tiny_config as jax_tiny_config
from transformertts_tpu.models import TransformerTTS as JaxTTS
from transformertts_tpu_torch.config import tiny_config
from transformertts_tpu_torch.convert import torch_state_from_jax
from transformertts_tpu_torch.models import TransformerTTS

TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def configs(r: int = 1, **runtime):
    """(JAX config, port config) of the tiny model with reduction factor r."""
    out = []
    for cfg in (jax_tiny_config(), tiny_config()):
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, reduction_factor=r),
            runtime=dataclasses.replace(cfg.runtime, **runtime),
        )
        out.append(cfg.validate())
    return tuple(out)


def randomize(variables, seed: int = 0):
    """Flax init with the zero/one-initialized leaves perturbed, so biases,
    LayerNorm/BatchNorm parameters, BatchNorm statistics and alpha are all
    exercised; returned as numpy."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name in ("scale", "alpha"):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


@functools.lru_cache(maxsize=None)
def _variables(r: int, seed: int):
    jcfg, _ = configs(r)
    model = JaxTTS(jcfg.model)
    args = (jnp.ones((1, 8), jnp.int32), jnp.zeros((1, 4 * r, jcfg.model.n_mels)),
            jnp.full((1,), 8), jnp.full((1,), 4 * r))
    init = jax.jit(lambda key: model.init({"params": key, "dropout": key}, *args, train=False))
    return randomize(init(jax.random.PRNGKey(seed)), seed)


def jax_model_and_variables(jcfg, dtype=jnp.float32, seed=0):
    """The JAX model in ``dtype`` and its (randomized, numpy) variables;
    the parameters are fp32 whatever the dtype, so they are made once."""
    return JaxTTS(jcfg.model, dtype=dtype), _variables(jcfg.model.reduction_factor, seed)


def port_model(pcfg, variables, dtype=torch.float32):
    model = TransformerTTS(pcfg.model, dtype=dtype, device="cpu")
    model.load_state_dict(torch_state_from_jax(variables, pcfg.model), strict=True)
    return model


def assert_close(port, ref, tol, what=""):
    port = np.asarray(port.float() if torch.is_tensor(port) else port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = float(np.max(np.abs(port - ref)))
    bound = tol * max(1.0, float(np.max(np.abs(ref))))
    assert err <= bound, f"{what}: max abs err {err:.3g} > {bound:.3g}"


def _inputs(r, seed=0):
    rng = np.random.default_rng(seed)
    b, tp, t_mel = 2, 16, 12 * r
    phoneme = rng.integers(1, 60, (b, tp)).astype(np.int32)
    lens = np.array([tp, 11], np.int32)
    mel = rng.standard_normal((b, t_mel, 80)).astype(np.float32)
    mel_lens = np.array([t_mel, 7 * r - 1], np.int32)
    return phoneme, lens, mel, mel_lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    jcfg, pcfg = configs()
    jmodel, variables = jax_model_and_variables(jcfg, getattr(jnp, dtype))
    model = port_model(pcfg, variables, getattr(torch, dtype))
    phoneme, lens, _, _ = _inputs(1)
    for with_lens in (True, False):
        ref = jax.jit(lambda v, l: jmodel.apply(v, phoneme, l, method=JaxTTS.encode))(
            variables, lens if with_lens else None)
        with torch.no_grad():
            out = model.encode(torch.from_numpy(phoneme).long(),
                               torch.from_numpy(lens).long() if with_lens else None)
        assert out.dtype == getattr(torch, dtype)
        assert_close(out, np.asarray(ref, np.float32), TOL[dtype], f"memory lens={with_lens}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [1, 2])
def test_forward_matches_jax(r, dtype):
    jcfg, pcfg = configs(r)
    jmodel, variables = jax_model_and_variables(jcfg, getattr(jnp, dtype))
    model = port_model(pcfg, variables, getattr(torch, dtype))
    phoneme, lens, mel, mel_lens = _inputs(r)
    ref = jax.jit(lambda v: jmodel.apply(v, phoneme, mel, lens, mel_lens, train=False))(variables)
    with torch.no_grad():
        out = model(torch.from_numpy(phoneme).long(), torch.from_numpy(mel),
                    torch.from_numpy(lens).long(), torch.from_numpy(mel_lens).long())
    assert set(out) == set(ref) == {"pred_melspec", "post_melspec", "pred_stop", "alignments"}
    for k in ref:
        assert_close(out[k], np.asarray(ref[k]), TOL[dtype], k)
