"""The port's KV-cached decode vs the JAX package's XLA decode loop.

``make_decode_fn(device="cpu")`` of the port, through both of its loops —
the plain loop and the kernel loop (whose step wrapper runs the plain
version of the CUDA kernel on CPU tensors) — against JAX
``make_decode_fn(use_megakernel=False)``, on the same weights and inputs:
B = 1 and B = 2 with ragged lengths, window W in {0, 2}, reduction factor
r in {1, 2}, forced full length (stop threshold 2.0), the stop path
(threshold 0.5) and an early stop (threshold 0.0 stops after one step).

Tolerance fp32, max|port - jax| <= 1e-4 * max(1, max|jax|): decoding feeds
each frame back, so the per-step summation-order differences (1e-6
relative) grow over the steps; the step counts must agree exactly.
"""

import functools

import jax
import numpy as np
import pytest

from tests.test_torch_models import assert_close, configs, jax_model_and_variables, port_model
from transformertts_tpu.infer.decode import make_decode_fn as jax_make_decode_fn
from transformertts_tpu.infer.decode import naive_decode as jax_naive_decode
from transformertts_tpu_torch.infer.decode import make_decode_fn, naive_decode

TOL = 1e-4
FRAMES = 12  # decoded frames per row when the stop never fires
NAIVE_FRAMES = 6  # the cacheless JAX loop compiles once per group


def _inputs(b):
    rng = np.random.default_rng(b)
    phoneme = rng.integers(1, 60, (b, 16)).astype(np.int32)
    lens = np.array([16, 11][:b], np.int32)
    return phoneme, lens


@functools.lru_cache(maxsize=None)
def _jax_decode(b, window, r, threshold):
    jcfg, _ = configs(r, decode_attn_window=window)
    model, variables = jax_model_and_variables(jcfg)
    fn = jax_make_decode_fn(model, jcfg, max_len=FRAMES * r, stop_threshold=threshold,
                            use_megakernel=False)
    return jax.device_get(fn(variables, *_inputs(b)))


def _check(b, window, r, threshold, use_kernel):
    ref = _jax_decode(b, window, r, threshold)
    jcfg, pcfg = configs(r, decode_attn_window=window)
    model = port_model(pcfg, jax_model_and_variables(jcfg)[1])
    fn = make_decode_fn(model, pcfg, max_len=FRAMES * r, stop_threshold=threshold,
                        use_kernel=use_kernel, device="cpu")
    out = fn(*_inputs(b))
    assert out["n_frames"] == int(ref["n_frames"])
    np.testing.assert_array_equal(out["n_frames_per_row"].numpy(), ref["n_frames_per_row"])
    for k in ("pred_melspec", "post_melspec", "pred_stop"):
        assert_close(out[k], ref[k], TOL, k)
    return out


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("window", [0, 2])
@pytest.mark.parametrize("b", [1, 2])
def test_decode_matches_jax(b, window, r, use_kernel):
    out = _check(b, window, r, 2.0, use_kernel)
    assert out["n_frames"] == FRAMES * r


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_decode_stop_path_matches_jax(use_kernel):
    _check(2, 0, 1, 0.5, use_kernel)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_decode_early_stop(use_kernel):
    out = _check(1, 0, 1, 0.0, use_kernel)
    assert out["n_frames"] == 1
    assert not out["pred_melspec"][:, 1:].any()  # frames past n_frames stay zero


@pytest.mark.parametrize("threshold", [2.0, 0.5])
@pytest.mark.parametrize("r", [1, 2])
def test_naive_decode_matches_jax_and_the_cached_loop(r, threshold):
    """The cacheless oracle (the reference's loop) against the JAX
    ``naive_decode`` and the port's cached plain loop: fp32, 1e-5 (one
    decoder over a prefix is the same arithmetic as the cached steps, up to
    summation order); equal frame counts.  The postnet (kernel 5) sees the
    cached loop's zero frames past an early stop, so the postnet frames are
    compared with the cached loop's only at full length."""
    jcfg, pcfg = configs(r)
    jmodel, variables = jax_model_and_variables(jcfg)
    phoneme, lens = _inputs(2)
    frames = NAIVE_FRAMES * r
    ref = jax.device_get(jax_naive_decode(jmodel, variables, phoneme, lens, frames, threshold))
    model = port_model(pcfg, variables)
    out = naive_decode(model, phoneme, lens, frames, threshold)
    n = out["n_frames"]
    assert n == int(ref["n_frames"]) and (threshold < 1.0 or n == frames)
    for k in ("pred_melspec", "post_melspec", "pred_stop"):
        assert_close(out[k], ref[k], 1e-5, k)
    cached = make_decode_fn(model, pcfg, max_len=frames, stop_threshold=threshold,
                            use_kernel=False, device="cpu")(phoneme, lens)
    assert cached["n_frames"] == n
    for k in ("pred_melspec", "pred_stop") + (("post_melspec",) if n == frames else ()):
        assert_close(out[k], cached[k][:, :n], 1e-5, k)


def test_decode_rejects_unported_options():
    """Speculative decode (tests/test_torch_speculative.py) and inference
    prenet dropout (tests/test_torch_prenet_dropout.py) each decode; the
    options that do not combine with speculation, prenet dropout and the
    attention window, raise as in JAX."""
    jcfg, pcfg = configs()
    model = port_model(pcfg, jax_model_and_variables(jcfg)[1])
    for extra in ({"infer_prenet_dropout": 0.5}, {"decode_attn_window": 2}):
        _, cfg = configs(decode_speculative_k=4, **extra)
        with pytest.raises(ValueError, match="incompatible"):
            make_decode_fn(model, cfg, max_len=8, device="cpu")
    for runtime in ({"infer_prenet_dropout": 0.5}, {"decode_speculative_k": 4}):
        _, cfg = configs(**runtime)
        out = make_decode_fn(model, cfg, max_len=8, stop_threshold=2.0, device="cpu")(*_inputs(1))
        assert out["n_frames"] == 8 and np.isfinite(out["post_melspec"].numpy()).all()
        assert ("n_verify_passes" in out) == ("decode_speculative_k" in runtime)


@pytest.mark.parametrize("threshold", [2.0, 0.5])
@pytest.mark.parametrize("window", [0, 2])
def test_kernel_loop_chunks_rows(window, threshold):
    """With ``decode_megakernel_max_batch = 1`` the kernel loop decodes a
    B = 2 batch as two one-row chunks, each to its own stop: every row
    matches the JAX loop up to its own length, and ``n_steps`` counts the
    steps of both chunks."""
    ref = _jax_decode(2, window, 1, threshold)
    jcfg, pcfg = configs(decode_attn_window=window, decode_megakernel_max_batch=1)
    model = port_model(pcfg, jax_model_and_variables(jcfg)[1])
    fn = make_decode_fn(model, pcfg, max_len=FRAMES, stop_threshold=threshold,
                        use_kernel=True, device="cpu")
    out = fn(*_inputs(2))
    assert out["n_frames"] == int(ref["n_frames"])
    lengths = ref["n_frames_per_row"]
    np.testing.assert_array_equal(out["n_frames_per_row"].numpy(), lengths)
    for row, n in enumerate(lengths):
        for k in ("pred_melspec", "pred_stop"):
            assert_close(out[k][row, :n], ref[k][row, :n], TOL, f"{k}[{row}]")
    if threshold == 2.0:  # no row stops early: the chunks decode alike
        assert out["n_steps"] == 2 * FRAMES
        assert_close(out["post_melspec"], ref["post_melspec"], TOL, "post_melspec")
    assert out["n_steps"] >= out["n_frames"]


def test_decode_gate_on_cuda(monkeypatch):
    """On CUDA the kernel loop is the decode path: with
    ``use_pallas_decode_step`` off the decode raises instead of serving
    through the plain loop, unless the caller asks for the plain loop."""
    import types

    import torch

    from transformertts_tpu_torch.infer import decode as decode_mod

    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(decode_mod, "resolve_device", lambda device: cuda)
    model = types.SimpleNamespace(device=cuda)
    _, cfg = configs(use_pallas_decode_step=False)
    with pytest.raises(ValueError, match="use_pallas_decode_step"):
        make_decode_fn(model, cfg, max_len=8)
    assert make_decode_fn(model, cfg, max_len=8, use_kernel=False) is not None
    _, on = configs()
    assert make_decode_fn(model, on, max_len=8) is not None
