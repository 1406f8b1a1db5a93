"""PyTorch port vs JAX package: the fused feed-forward block.

The same numpy-seeded inputs and the same int32 seed go through the JAX
``fused_ffn._fused`` (Pallas, ``interpret=True``) and the port's
``fused_ffn`` on the CPU (its plain version), forward and all five
gradients.  The port takes the weights in the layout of the PyTorch
parameters, (F, D) and (D, F): the transposes of the flax kernels.  With
dropout on, agreement means both drop the same elements; N is chosen so
that the TPU kernel works in at least two row blocks (``_pick_rows``), once
with a block height that divides N and once where it pads N.

Tolerances:
- fp32, absolute, as ``tests/test_pallas_fused_ffn.py`` holds the Pallas
  kernel to XLA: 1e-4 forward, 2e-4 gradients (same arithmetic, other
  summation order; the parameter gradients sum over all N rows);
- bf16: 2e-2 of max(1, max|jax|) (both round hd, dh and the results once to
  bf16; a different summation order moves single values by one bf16 ulp);
- the model and the training step with the flag on: as
  ``tests/test_torch_models.py`` and ``tests/test_torch_train_step.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import _inputs as model_inputs
from tests.test_torch_models import _variables, assert_close, configs
from tests.test_torch_train_step import _batch, _close, _close_tree, _configs
from transformertts_tpu.models import TransformerTTS as JaxTTS
from transformertts_tpu.models.factory import runtime_model_kwargs as jax_runtime_kwargs
from transformertts_tpu.ops.pallas import fused_ffn as jax_ffn
from transformertts_tpu.ops.pallas.dropout_mask import seed_from_rng
from transformertts_tpu.train import train_step as jax_ts
from transformertts_tpu_torch.convert import torch_state_from_jax
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.models.factory import runtime_model_kwargs
from transformertts_tpu_torch.ops import fused_ffn as port_ffn
from transformertts_tpu_torch.ops.fused_ffn import fused_ffn, pick_rows
from transformertts_tpu_torch.train import train_step as ts


def _inputs(n, d, f, dtype, seed=0):
    """JAX arrays (flax layout) and tensors (PyTorch layout) of one call."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.05).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(x, jd)] + [jnp.asarray(a) for a in (w1, b1, w2, b2)]
    tx = [torch.tensor(x).to(td), torch.tensor(w1.T.copy()), torch.tensor(b1),
          torch.tensor(w2.T.copy()), torch.tensor(b2)]
    return jx, tx, jnp.asarray(dy, jd), torch.tensor(dy).to(td)


@pytest.mark.parametrize("n,d,f,itemsize", [
    (1024, 128, 512, 4), (300, 64, 96, 4), (12288, 256, 1024, 2), (12288, 256, 1024, 4),
    (2048, 256, 1024, 2), (1001, 256, 1000, 2),
    (512, 256, 3072, 2), (512, 256, 3072, 4),  # bf16 and fp32 pick different heights
])
def test_pick_rows_matches_jax(n, d, f, itemsize):
    assert pick_rows(n, d, f, itemsize) == jax_ffn._pick_rows(n, d, f, itemsize)


def test_pick_rows_depends_on_the_itemsize_and_raises_where_jax_does():
    assert pick_rows(512, 256, 3072, 2) != pick_rows(512, 256, 3072, 4)
    assert not jax_ffn.fused_ffn_fits(256, 4096, 4)
    with pytest.raises(ValueError, match="mask geometry"):
        pick_rows(512, 256, 4096, 4)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("n,d,f", [(512, 128, 256), (300, 64, 96)])
def test_forward_and_gradients_match_jax(n, d, f, dropout):
    jx, tx, jdy, dy = _inputs(n, d, f, "float32")
    rows = jax_ffn._pick_rows(n, d, f, 4)
    assert -(-n // rows) >= 2  # at least two row blocks
    assert (n % rows == 0) == (n == 512)  # one shape divides, the other is padded
    jseed = seed_from_rng(dropout, jax.random.PRNGKey(3))

    def f_jax(x_, w1_, b1_, w2_, b2_):
        return jax_ffn._fused(x_, w1_, b1_, w2_, b2_, jseed, dropout, True)

    ref, vjp = jax.vjp(f_jax, *jx)
    ref_grads = vjp(jdy)

    for t in tx:
        t.requires_grad_(True)
    out = fused_ffn(*tx, dropout=dropout, seed=int(jseed[0]))
    assert out.dtype == tx[0].dtype
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4)
    out.backward(dy)
    for name, t, r, transpose in zip(("dx", "dw1", "db1", "dw2", "db2"), tx, ref_grads,
                                     (False, True, False, True, False)):
        r = np.asarray(r)
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.numpy(), r.T if transpose else r, atol=2e-4,
                                   err_msg=name)
    assert fused_ffn.launches_fwd == 0 and fused_ffn.launches_bwd == 0  # the CPU never launches


def test_bf16_forward_and_gradients_match_jax():
    n, d, f = 512, 128, 256
    jx, tx, jdy, dy = _inputs(n, d, f, "bfloat16", seed=1)
    jseed = jnp.zeros((1,), jnp.int32)
    ref, vjp = jax.vjp(lambda *a: jax_ffn._fused(*a, jseed, 0.0, True), *jx)
    ref_grads = vjp(jdy)
    for t in tx:
        t.requires_grad_(True)
    out = fused_ffn(*tx)
    assert out.dtype == torch.bfloat16
    assert_close(out.detach(), np.asarray(ref, np.float32), 2e-2, "y")
    out.backward(dy)
    for name, t, r, transpose in zip(("dx", "dw1", "db1", "dw2", "db2"), tx, ref_grads,
                                     (False, True, False, True, False)):
        r = np.asarray(r, np.float32)
        assert t.grad.dtype == t.dtype
        assert_close(t.grad, r.T if transpose else r, 2e-2, name)


def test_bf16_backward_with_dropout_at_ragged_tiles_matches_jax():
    """N and F no multiples of the tensor-core kernels' 64-wide tiles.  x in
    eighths and W1, b1 in 64ths of small integers keep the first product
    exact in any summation order, so both sides take the same relu
    decisions (as chip_smoke.py's inputs do)."""
    n, d, f, p = 130, 64, 200, 0.1
    rng = np.random.default_rng(5)
    x = (np.clip(np.round(rng.standard_normal((n, d)) * 8), -24, 24) / 8).astype(np.float32)
    w1 = (np.clip(np.round(rng.standard_normal((d, f)) * 4), -12, 12) / 64).astype(np.float32)
    b1 = (np.round(rng.standard_normal(f) * 6) / 64).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) * 0.06).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    jx = [jnp.asarray(x, jnp.bfloat16)] + [jnp.asarray(a) for a in (w1, b1, w2, b2)]
    jseed = jnp.array([977], jnp.int32)
    ref, vjp = jax.vjp(lambda *a: jax_ffn._fused(*a, jseed, p, True), *jx)
    ref_grads = vjp(jnp.asarray(dy, jnp.bfloat16))
    tx = [torch.tensor(x).to(torch.bfloat16), torch.tensor(w1.T.copy()), torch.tensor(b1),
          torch.tensor(w2.T.copy()), torch.tensor(b2)]
    for t in tx:
        t.requires_grad_(True)
    out = fused_ffn(*tx, dropout=p, seed=977)
    assert_close(out.detach(), np.asarray(ref, np.float32), 2e-2, "y")
    out.backward(torch.tensor(dy).to(torch.bfloat16))
    for name, t, r, transpose in zip(("dx", "dw1", "db1", "dw2", "db2"), tx, ref_grads,
                                     (False, True, False, True, False)):
        r = np.asarray(r, np.float32)
        assert_close(t.grad, r.T if transpose else r, 2e-2, name)


@pytest.mark.parametrize("n,d,f", [
    (12288, 256, 1024), (2048, 256, 1024), (1001, 256, 1000), (130, 64, 196),
    (520, 192, 264), (192, 256, 3072), (1000, 512, 2048), (264, 1024, 4096), (1, 8, 4),
])
def test_bf16_backward_plan_and_scratch(n, d, f):
    """The grids cover every slice and row tile exactly once, and the
    scratch arrays are 256-byte aligned, disjoint and of the sizes the
    kernels index."""
    pl = port_ffn.bwd_plan(n, d, f)
    tiles, dx_slices = -(-n // 64), 2 * -(-f // 64)
    assert pl["tiles"] == tiles and pl["fp"] == 64 * -(-f // 64) and pl["dp"] == 64 * -(-d // 64)
    assert (pl["fgroups"] - 1) * pl["spg"] < dx_slices <= pl["fgroups"] * pl["spg"]
    assert (pl["chunks"] - 1) * pl["tpc"] < tiles <= pl["chunks"] * pl["tpc"]
    lay = port_ffn.bwd_scratch(n, d, f)
    want = {"w1b": 2 * pl["fp"] * pl["dp"], "w2b": 2 * pl["fp"] * pl["dp"],
            "dh": 2 * n * pl["fp"], "hd": 2 * n * pl["fp"], "pdb1": 4 * tiles * f,
            "pdb2": 4 * tiles * d, "pw1": 4 * pl["chunks"] * f * d,
            "pw2": 4 * pl["chunks"] * f * d}
    assert {k: size for k, (_, size) in lay.items() if k != "total"} == want
    spans = sorted((off, off + size) for k, (off, size) in lay.items() if k != "total")
    assert all(off % 256 == 0 for off, _ in spans)
    assert all(a_end <= b_off for (_, a_end), (b_off, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= lay["total"][1]


def test_bf16_backward_plan_splits_d_ffn_to_fill_the_last_wave():
    """The dh kernel runs one block on each of 132 SMs: the decoder's 192 row
    tiles take d_ffn in 2 groups (384 blocks, 97 % of three waves), the
    encoder's 32 in 4 (128 blocks, one wave)."""
    dec, enc = port_ffn.bwd_plan(12288, 256, 1024), port_ffn.bwd_plan(2048, 256, 1024)
    assert (dec["fgroups"], dec["spg"]) == (2, 16)
    assert (enc["fgroups"], enc["spg"]) == (4, 8)


# the shapes chip_smoke.py holds the kernels to on the card, the two path
# shapes first
FWD_SHAPES = [(12288, 256, 1024), (2048, 256, 1024), (1001, 256, 1000), (130, 64, 196),
              (520, 192, 264), (192, 256, 3072), (1000, 512, 2048), (264, 1024, 4096),
              (12288, 512, 2048), (1, 8, 4)]


@pytest.mark.parametrize("n,d,f", FWD_SHAPES)
def test_bf16_forward_plan_owns_every_tile_once(n, d, f):
    """The bf16 forward's grid: every (row tile, d_ffn slice, output group)
    is taken by exactly one block, each block's partial rows are added by
    exactly one block of its cluster over every rank in rank order, and the
    shared memory and staged weights are the sizes the kernel indexes."""
    pl = port_ffn.fwd_plan(n, d, f)
    wgs, s, fs = pl["wgs"], pl["s"], pl["fsplit"]
    assert (s, wgs) == ((64, 2) if d <= 256 else (32, 1))
    assert pl["dp"] == (256 if d <= 256 else 512 if d <= 512 else 1024)
    assert (pl["stages"] == 1) == (pl["dp"] == 1024)  # x leaves room for one stage only there
    assert pl["grid"] == (fs, -(-n // (64 * wgs)), -(-d // 256)) and pl["threads"] == 128 * wgs
    assert fs in (1, 2, 4, 8) and fs <= pl["slices"] == pl["fp"] // s
    owned = {}
    for part, rb, g in np.ndindex(*pl["grid"]):
        for w in range(wgs):
            for sl in port_ffn.fwd_parts(pl["slices"], fs)[part]:
                key = (rb * wgs + w, sl, g)
                owned[key] = owned.get(key, 0) + 1
    tiles = -(-n // 64)
    want = {(t, sl, g) for t in range(tiles) for sl in range(pl["slices"])
            for g in range(pl["groups"])}
    assert want <= set(owned) and all(c == 1 for c in owned.values())
    assert all(t < tiles + wgs - 1 for t, _, _ in owned)  # only the last block pads
    rows = port_ffn.fwd_reduce_rows(wgs, fs)
    assert sorted(r for q in rows for r in q) == list(range(64 * wgs))
    assert all(list(q) == list(range(rank, 64 * wgs, fs)) for rank, q in enumerate(rows))
    x_bytes, stage = wgs * 64 * pl["dp"] * 2, s * pl["dp"] * 2 + 256 * s * 2

    def smem(k):  # x and the ring, or the fp32 partial y; an mbarrier and a counter a stage
        return max(x_bytes + k * stage, wgs * 64 * 264 * 4) + 12 * k + 1024

    k = pl["stages"]
    assert pl["smem"] == smem(k) and (k == 1 or smem(k) <= 232448)
    assert k == 4 or smem(k + 1) > 232448  # the deepest ring that fits
    assert pl["staged_bytes"] == pl["slices"] * (s * pl["dp"] + pl["groups"] * 256 * s) * 2


def test_bf16_forward_plan_picks_the_measured_split_and_raises_above_its_widths():
    """On an H100 the decoder's 96 blocks of 128 rows run fastest unsplit (a
    cluster's reduction costs more than the idle SMs), the encoder's 16 in
    clusters of 4 (64 blocks); d_model above 1,024 has no plan."""
    dec, enc = port_ffn.fwd_plan(12288, 256, 1024), port_ffn.fwd_plan(2048, 256, 1024)
    assert (dec["fsplit"], dec["grid"], dec["stages"]) == (1, (1, 96, 1), 2)
    assert (enc["fsplit"], enc["grid"], enc["stages"]) == (4, (4, 16, 1), 2)
    with pytest.raises(ValueError, match="d_model up to 1024"):
        port_ffn.fwd_plan(64, 1032, 256)


def test_dropout_drops_the_same_elements_as_jax():
    """With identity weights and x > 0 a dropped element of the intermediate
    shows directly in y: compare the pattern, not just the values."""
    n, d, seed, p = 512, 128, 42, 0.5
    assert jax_ffn._pick_rows(n, d, d, 4) == 256  # two mask blocks
    x = np.ones((n, d), np.float32)
    eye, zero = np.eye(d, dtype=np.float32), np.zeros(d, np.float32)
    ref = jax_ffn._fused(jnp.asarray(x), jnp.asarray(eye), jnp.asarray(zero), jnp.asarray(eye),
                         jnp.asarray(zero), jnp.array([seed], jnp.int32), p, True)
    out = fused_ffn(torch.tensor(x), torch.tensor(eye), torch.tensor(zero), torch.tensor(eye),
                    torch.tensor(zero), dropout=p, seed=seed)
    np.testing.assert_array_equal(out.numpy() > 0, np.asarray(ref) > 0)
    assert 0.4 < float((out > 0).float().mean()) < 0.6


def test_leading_axes_and_mask_rows_argument():
    _, (x, w1, b1, w2, b2), _, _ = _inputs(64, 32, 48, "float32", seed=3)
    flat = fused_ffn(x, w1, b1, w2, b2, dropout=0.2, seed=9, mask_rows=16)
    shaped = fused_ffn(x.reshape(4, 16, 32), w1, b1, w2, b2, dropout=0.2, seed=9, mask_rows=16)
    assert torch.equal(flat, shaped.reshape(64, 32))
    other = fused_ffn(x, w1, b1, w2, b2, dropout=0.2, seed=9, mask_rows=64)
    assert not torch.equal(flat, other)  # the block height is part of the mask


# --- the model and the training step with the flag on, against the JAX
# --- package built with use_fused_ffn=True directly (its factory gates the
# --- flag on d_model % 128, a TPU rule the tiny widths need not meet)

def _port_model(pcfg, variables, **kw):
    model = TransformerTTS(pcfg.model, device="cpu", use_fused_ffn=True, **kw)
    model.load_state_dict(torch_state_from_jax(variables, pcfg.model), strict=True)
    return model


def test_model_with_fused_ffn_matches_jax_outputs_and_gradients():
    jcfg, pcfg = configs()
    variables = _variables(1, 0)
    jmodel = JaxTTS(jcfg.model, use_fused_ffn=True)
    phoneme, lens, mel, mel_lens = model_inputs(1)

    def loss(params):
        out = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           phoneme, mel, lens, mel_lens, train=False, return_alignments=False)
        return jnp.sum(out["post_melspec"] ** 2) + jnp.sum(out["pred_stop"] ** 2), out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])

    model = _port_model(pcfg, variables)
    assert all(layer.ffn.use_fused for layer in model.decoder.layers)
    out = model(torch.from_numpy(phoneme).long(), torch.from_numpy(mel),
                torch.from_numpy(lens).long(), torch.from_numpy(mel_lens).long(),
                return_alignments=False)
    for key in ("pred_melspec", "post_melspec", "pred_stop"):
        assert_close(out[key].detach(), ref[key], 1e-5, key)
    ((out["post_melspec"] ** 2).sum() + (out["pred_stop"] ** 2).sum()).backward()
    norm = float(jax_ts.optax.global_norm(grads))
    _close_tree({n: p.grad for n, p in model.named_parameters()}, grads, pcfg, 1e-3, 1e-5 * norm,
                "grad")


def test_training_step_with_fused_ffn_matches_jax():
    jcfg, pcfg = _configs()
    on = dict(use_pallas_fused_ffn=True)
    pcfg = pcfg.replace(runtime=dataclasses.replace(pcfg.runtime, **on))
    variables = _variables(1, 0)
    jmodel = JaxTTS(jcfg.model, **{**jax_runtime_kwargs(jcfg), "use_fused_ffn": True})
    jstep = jax_ts.make_train_step(jmodel, jcfg, scheduled_sampling=True, donate=False)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax_ts.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jax_ts.make_optimizer(jcfg).init(params))
    batch = _batch(seed=21, k=1)
    jstate, jmetrics = jstep(jstate, batch, 1.0, jax.random.PRNGKey(0))

    kwargs = runtime_model_kwargs(pcfg, device="cpu")
    assert kwargs["use_fused_ffn"]
    model = TransformerTTS(pcfg.model, **kwargs)
    model.load_state_dict(torch_state_from_jax(variables, pcfg.model), strict=True)
    state = ts.create_train_state(model, pcfg)
    state, metrics = ts.make_train_step(model, pcfg)(state, batch, 1.0,
                                                     torch.Generator().manual_seed(0))
    for name in ("total", "pred_mel", "post_mel", "stop", "grad_norm"):
        _close(metrics[name], jmetrics[name], 1e-5, 1.0, f"step {name}")
    adam = jstate.opt_state[2]
    assert state.opt_state["count"] == int(adam.count) == 1
    _close_tree(state.opt_state["mu"], adam.mu, pcfg, 1e-3, 1e-6, "mu")
    _close_tree(state.opt_state["nu"], adam.nu, pcfg, 1e-3, 1e-9, "nu")
    # the eval step goes through the op too (dropout 0)
    ev = ts.make_eval_step(model, pcfg)(state, {k: v[0] for k, v in batch.items()})
    assert all(np.isfinite(float(v)) for v in ev.values())
