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

The stop votes read back ``LAG`` steps late (``StopVotes``): with votes
forced at every offset of the lag window (``tests/decode_votes.py``), the
one-shot decode equals the decode that reads them after every step, bit
for bit, on both loops, B 1, 2 and 10, r 1 and 2, W 0 and 2.
"""

import functools

import jax
import numpy as np
import pytest

from tests import decode_votes
from tests.test_torch_models import assert_close, configs, jax_model_and_variables, port_model
from transformertts_tpu.infer.decode import make_decode_fn as jax_make_decode_fn
from transformertts_tpu.infer.decode import naive_decode as jax_naive_decode
from transformertts_tpu_torch.infer import decode as decode_mod
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


# ------------------------------------- the decode step prepared once per shape

def _plan_hits(fn, phoneme, lens):
    """``hit`` of each ``decode.plan`` span of one decode (stream or not)."""
    import time

    from transformertts_tpu_torch.utils import trace

    t0 = time.perf_counter_ns()
    out = fn(phoneme, lens)
    return out, [s.attrs["hit"] for s in trace.spans()
                 if s.name == "decode.plan" and s.start_ns >= t0]


@pytest.mark.parametrize("n_pos", [1, 12, 576])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pe_table_is_the_numpy_table_bit_for_bit(dtype, n_pos):
    """The kernel loop's PE rows, ``alpha * PE[:n_pos]`` from the model's
    own table, are the float64-built numpy table's rows times alpha, bit for
    bit, whatever the compute dtype (the table stays fp32)."""
    import torch

    from transformertts_tpu_torch.infer.decode import pe_table
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.models.modules import sinusoid_table

    _, pcfg = configs()
    m = pcfg.model
    model = TransformerTTS(m, dtype=getattr(torch, dtype), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.pe.alpha.fill_(0.7312)
    assert model.pe.pe.dtype == torch.float32
    want = (model.pe.alpha.float() * torch.from_numpy(
        sinusoid_table(m.max_len, m.d_model))).float()[:n_pos]
    got = pe_table(model, n_pos)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("kind", ["oneshot", "stream"])
def test_decode_plan_hits_after_the_first_decode_of_a_shape(kind):
    """Each kernel-loop ``decode.plan`` span carries ``hit``: false at the
    first decode of a (rows, n_pos, max(n_pos, Tp)) shape, true at the next,
    also for another prompt bucket under n_pos, and false again after a
    parameter was written; a decode and a stream sharing one
    ``DecodeWeights`` share its shapes.  Cold and warm decodes give the
    same frames, stop logits and lengths, bit for bit."""
    import torch

    from transformertts_tpu_torch.infer.decode import DecodeWeights
    from transformertts_tpu_torch.infer.streaming import make_stream_fns, stream_chunks

    jcfg, pcfg = configs(decode_megakernel_max_batch=2)
    model = port_model(pcfg, jax_model_and_variables(jcfg)[1])
    weights = DecodeWeights(model)
    one = make_decode_fn(model, pcfg, max_len=24, stop_threshold=2.0, use_kernel=True,
                         device="cpu", weights=weights)
    if kind == "stream":
        fns = make_stream_fns(model, pcfg, max_len=24, chunk=8, stop_threshold=2.0,
                              use_kernel=True, device="cpu", weights=weights)

        def fn(phoneme, lens):
            state = fns[0](phoneme, lens)
            list(stream_chunks(fns, pcfg, state, 24))
            return {"pred_melspec": state.frames, "pred_stop": state.stops}
    else:
        fn = one
    phoneme, lens = _inputs(2)  # Tp 16 under n_pos 24: chunks of 2 rows
    cold, hits = _plan_hits(fn, phoneme, lens)
    assert hits == [False]
    warm, hits = _plan_hits(fn, phoneme, lens)
    assert hits == [True]
    for k in ("pred_melspec", "pred_stop"):
        assert torch.equal(cold[k], warm[k]), k
    assert _plan_hits(fn, phoneme[:, :8], np.minimum(lens, 8))[1] == [True]  # another bucket
    assert _plan_hits(fn, np.tile(phoneme, (1, 2)), lens)[1] == [False]  # Tp 32 over n_pos
    assert _plan_hits(fn, phoneme[:1], lens[:1])[1] == [False]  # one row: another shape
    assert _plan_hits(one if kind == "stream" else fn, phoneme[:1], lens[:1])[1] == [True]
    with torch.no_grad():
        model.decoder.layers[0].ffn.Dense_0.bias.add_(0.25)
    assert _plan_hits(fn, phoneme, lens)[1] == [False]
    assert _plan_hits(fn, phoneme, lens)[1] == [True]


@pytest.fixture
def fake_card(monkeypatch):
    """The decode library's occupancy query answered as a card that holds
    7 clusters of 16 blocks, 11 of 12 and 16 of 8: ``DecodeWeights`` then
    prepares the kernel's plan and tables for a CUDA device name, on the
    CPU tensors of the model (the kernel itself never runs)."""
    from transformertts_tpu_torch.ops import decode_step as ds

    class Card:
        def tts_decode_step_max_clusters(self, is_bf16, rows, smem, cluster):
            return {16: 7, 12: 11, 8: 16}[cluster] if smem <= ds.SMEM_LIMIT else 0

    monkeypatch.setattr(ds, "_lib", lambda name="decode_step": Card())
    ds._card_plan_of.cache_clear()
    yield
    ds._card_plan_of.cache_clear()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parameter_write_gives_a_new_bias_table(fake_card, dtype):
    """The step's preparation is kept per shape beside the packed weights:
    another Tp under n_pos takes the same one; after a parameter write the
    weights are packed again and the shape prepared again, with a bias
    table of the new biases, PE rows of the new alpha and the new weights'
    pointers."""
    import torch

    from transformertts_tpu_torch.infer.decode import DecodeWeights, pe_table
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.ops.decode_step import (
        _PACK_ORDER,
        bias_table,
        pack_decode_weights,
        stage_biases,
    )

    _, pcfg = configs()
    m = pcfg.model
    model = TransformerTTS(m, dtype=getattr(torch, dtype), device="cpu",
                           generator=torch.Generator().manual_seed(1))
    weights, cuda = DecodeWeights(model), torch.device("cuda", 0)
    packed, pe, prep, hit = weights.prepared(3, 24, 16, cuda)
    assert not hit and prep.shape == (3, 24, 24) and prep.cluster == 16 and prep.rows == 1
    again = weights.prepared(3, 24, 8, cuda)
    assert again[3] and again[2] is prep and again[1] is pe and again[0] is packed
    with torch.no_grad():
        model.decoder.layers[1].self_attn.out_proj.bias.add_(1.5)
        model.pe.alpha.mul_(3.0)
    packed2, pe2, prep2, hit2 = weights.prepared(3, 24, 16, cuda)
    assert not hit2 and packed2 is not packed
    want = bias_table(stage_biases(pack_decode_weights(model, model.dtype), m.decoder_n_layers),
                      prep2.plan[0], prep2.plan[1], prep2.plan[2]["n_bias"])
    assert torch.equal(prep2.tensors[2], want) and not torch.equal(prep2.tensors[2], prep.tensors[2])
    assert torch.equal(pe2, pe_table(model, 24)) and not torch.equal(pe2, pe)
    assert prep2.pointers == tuple(packed2[k].data_ptr() for k in _PACK_ORDER)


def test_decode_weights_under_threads(fake_card):
    """Threads preparing the same shapes at once get one preparation a
    shape: the lock keeps a second one from replacing the first."""
    import sys
    import threading

    import torch

    from transformertts_tpu_torch.infer.decode import DecodeWeights
    from transformertts_tpu_torch.models import TransformerTTS

    _, pcfg = configs()
    model = TransformerTTS(pcfg.model, dtype=torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    weights, cuda = DecodeWeights(model), torch.device("cuda", 0)
    shapes = [(b, n_pos, 16) for b in (1, 2, 3) for n_pos in (12, 24)]
    seen: dict = {}
    lock = threading.Lock()

    def work(i):
        for j in range(30):
            shape = shapes[(i + j) % len(shapes)]
            _, pe, prep, _ = weights.prepared(*shape, cuda)
            with lock:
                seen.setdefault(shape, set()).add((id(pe), id(prep)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(seen) == sorted(shapes)
    assert all(len(ids) == 1 for ids in seen.values()), seen


# ------------------------------------- the stop votes read back LAG steps late

LAG_POS = 20  # decoded positions: room for a stop 2 LAG deep and for none
LAG_SETUPS = {  # id -> (use_kernel, B, r, window): B 10 is two chunks of rows
    "plain-b2-r1-w0": (False, 2, 1, 0),
    "kernel-b10-r1-w2": (True, 10, 1, 2),
    "kernel-b1-r2-w0": (True, 1, 2, 0),
    "plain-b10-r2-w2": (False, 10, 2, 2),
}


def _lag_inputs(b):
    rng = np.random.default_rng(100 + b)
    lens = rng.integers(8, 17, b)
    lens[0] = 16
    return rng.integers(1, 60, (b, 16)).astype(np.int32), lens.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _lag_model(r, window):
    jcfg, pcfg = configs(r, decode_attn_window=window, decode_megakernel_max_batch=8)
    return pcfg, port_model(pcfg, jax_model_and_variables(jcfg)[1])


@pytest.mark.parametrize("last", decode_votes.last_votes() + [LAG_POS - 1, None])
@pytest.mark.parametrize("setup", list(LAG_SETUPS))
def test_late_stop_readback_equals_per_step_readback(monkeypatch, setup, last):
    """The one-shot decode (``run_each``) with the last row voting at each
    offset of the lag window, at the last position or never: the result
    read ``LAG`` steps late equals, bit for bit, the one read after every
    step; each chunk of rows keeps the steps up to its own stop, the
    steps it ran past the stop are rolled back (zero frames, ``NEG_INF``
    stop logits) and counted as ``overrun``, and the host waited as often
    as ``lag_counts`` says."""
    use_kernel, b, r, window = LAG_SETUPS[setup]
    pcfg, model = _lag_model(r, window)
    votes = decode_votes.vote_steps(b, last)
    fn = make_decode_fn(model, pcfg, max_len=LAG_POS * r, stop_threshold=decode_votes.THRESHOLD,
                        use_kernel=use_kernel, device="cpu")
    runs = {lag: decode_votes.decode_with_votes(monkeypatch, lag, votes,
                                                lambda: fn(*_lag_inputs(b)))
            for lag in (1, decode_mod.LAG)}
    decode_votes.assert_same(runs[1][0], runs[decode_mod.LAG][0])
    chunk = 8 if use_kernel else b
    for lag, (out, loops, calls) in runs.items():
        assert len(loops) == 1
        kept = waits = 0
        for lo in range(0, b, chunk):
            rows = slice(lo, lo + chunk)
            stop = decode_votes.chunk_stop(votes, rows)
            ran, w = decode_votes.lag_counts(LAG_POS, stop, lag)
            n = LAG_POS if stop is None else stop + 1
            decode_votes.assert_rolled_back(out, rows, n, r)
            kept, waits = kept + n, waits + w
        assert out["n_steps"] == loops[0].attrs["steps"] == kept
        assert loops[0].attrs["overrun"] == calls - kept
        assert loops[0].attrs["waits"] == waits
        assert calls - kept <= (2 * lag - 1) * -(-b // chunk)
