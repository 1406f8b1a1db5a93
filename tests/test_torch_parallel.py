"""The port's data, tensor and sequence parallelism (``parallel/``) on the
CPU over gloo: the counterparts of ``tests/test_sharding.py``,
``tests/test_collectives_audit.py`` and ``tests/test_multihost.py``.

One group of four spawned workers (``tests/torch_parallel_cases.py``) runs
every multi-process case; the one-process port step, computed here on the
same global batch, seeds and weights, is the reference.  ``tiny_config``,
fp32, dropout on (every mask keyed on the one-process step's indices),
scheduled sampling and guided attention on, 2 micro-batches of 4 rows.

Tolerances: loss ``rel 2e-5`` and grad norm ``rel 2e-4`` (the JAX tests'
``test_collectives_audit.py:138-139``); parameters, Adam moments, EMA and
BatchNorm statistics after the step within 1e-5 absolute (only summation
order differs).  The one-process port step is held to the JAX step by
``tests/test_torch_train_step.py``; two more cases, (1, 2) + SP and (2, 2)
+ SP with dropout off, hold the sharded step to the JAX step directly, on
that module's weights, batch and tolerances.
"""

import json
import os
import socket
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tests import torch_parallel_cases as cases
from tests.test_data import corpus  # noqa: F401  (fixture)
from tests.test_torch_models import _variables
from tests.test_torch_train_step import _batch as train_step_batch
from tests.test_torch_train_step import _close, _close_tree, _close_updates
from tests.test_torch_train_step import _configs as train_step_configs
from tests.test_torch_trainer import micro_overrides
from transformertts_tpu.config import Config as JaxConfig
from transformertts_tpu.config import load_config as jax_load_config
from transformertts_tpu.models import TransformerTTS as JaxTTS
from transformertts_tpu.models.factory import runtime_model_kwargs as jax_runtime_kwargs
from transformertts_tpu.parallel import param_spec as jax_param_spec
from transformertts_tpu.train import train_step as jax_ts
from transformertts_tpu_torch.config import Config, load_config
from transformertts_tpu_torch.convert import torch_state_from_jax
from transformertts_tpu_torch.entry import dryrun_multichip
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.ops import flash_attention as fa
from transformertts_tpu_torch.ops import fused_ffn as ffn
from transformertts_tpu_torch.ops import fused_ln as ln
from transformertts_tpu_torch.parallel import make_mesh, param_spec, shard_batch
from transformertts_tpu_torch.parallel.mesh import Mesh
from transformertts_tpu_torch.train import create_train_state, make_train_step
from transformertts_tpu_torch.train import train_step as ts
from transformertts_tpu_torch.train.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
LARGE_TP = ROOT / "configs" / "large_tp.yaml"
STEP_CASES = {  # name -> (mesh, ranks, sequence parallel, config, batch seed)
    "dp": ((2, 1), [0, 1], False, {}, 0),
    "tp": ((1, 2), [2, 3], False, {"ema": 0.99}, 0),
    "tp_sp": ((1, 2), [0, 1], True, {}, 0),
    "dp_tp_sp_ffn": ((2, 2), [0, 1, 2, 3], True, {"ffn": True}, 0),
    "restored_sp": ((1, 2), [0, 1], True, {}, 5),
}
JAX_CASES = {"jax_tp_sp": ((1, 2), [2, 3]), "jax_dp_tp_sp": ((2, 2), [0, 1, 2, 3])}
SP_OVERRIDES = ["runtime.mesh_model=2", "runtime.shard_sequence=true"]


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _plan(tmp: Path, jax_ref: dict) -> list:
    def step(name, **extra):
        mesh, ranks, sp, cfg, seed = STEP_CASES[name]
        return dict(name=name, mesh=mesh, ranks=ranks, sp=sp, cfg=cfg, seed=seed, kind="step",
                    **extra)

    def jax_step(name):
        mesh, ranks = JAX_CASES[name]
        return dict(name=name, mesh=mesh, ranks=ranks, sp=True, kind="step",
                    config=jax_ref["pcfg"], data=jax_ref["data"], p_tf=1.0,
                    weights=str(tmp / "jax_weights.pt"))

    return [
        [step("dp"), step("tp", save=str(tmp / "saved_tp"))],
        [step("tp_sp"), dict(name="skip", mesh=(2, 1), ranks=[2, 3], sp=False, kind="step",
                             poison_rank=1)],
        [step("dp_tp_sp_ffn")],
        [jax_step("jax_dp_tp_sp")],
        [dict(name="fwd_tp", mesh=(1, 2), ranks=[0, 1], sp=False, kind="forward"),
         dict(name="fwd_sp", mesh=(1, 2), ranks=[2, 3], sp=True, kind="forward")],
        [step("restored_sp", restore=str(tmp / "one")), jax_step("jax_tp_sp")],
    ]


def _jax_reference(tmp: Path) -> dict:
    """One JAX train step as ``tests/test_torch_train_step.py``'s ``both``
    fixture builds it (dropout off, ``p_tf`` 1, Pallas in interpret mode),
    its weights saved for the ``jax_*`` cases as a torch state dict."""
    jcfg, pcfg = train_step_configs()
    variables = _variables(1, 0)
    jmodel = JaxTTS(jcfg.model, **jax_runtime_kwargs(jcfg))
    jstep = jax_ts.make_train_step(jmodel, jcfg, scheduled_sampling=True, donate=False)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax_ts.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jax_ts.make_optimizer(jcfg).init(params))
    data = train_step_batch(seed=10)
    jnext, metrics = jax.device_get(jstep(jstate, data, 1.0, jax.random.PRNGKey(0)))
    before = torch_state_from_jax(variables, pcfg.model)
    torch.save(before, tmp / "jax_weights.pt")
    after = torch_state_from_jax({"params": jnext.params, "batch_stats": jnext.batch_stats},
                                 pcfg.model)
    stats = ts._batch_stats(TransformerTTS(pcfg.model, device="meta"))
    adam = jnext.opt_state[2]
    return {"pcfg": pcfg, "data": data, "metrics": metrics, "before": before,
            "update": jax.tree.map(lambda a, b: a - b, jnext.params, jax.device_get(params)),
            "mu": adam.mu, "nu": adam.nu, "stats": {n: after[n] for n in stats}}


@pytest.fixture(scope="module")
def pool(tmp_path_factory, corpus):  # noqa: F811
    """The one-process references, then every sharded case in one group of
    workers; after the group, a 2-process ``cli train --distributed`` at
    (1, 2) + SP beside the one-process ``cli train``."""
    tmp = tmp_path_factory.mktemp("parallel")
    refs = {}
    for name, (_, _, _, cfg, seed) in STEP_CASES.items():
        if name != "restored_sp":
            refs[name] = cases.one_process_step(cases.config(**cfg), cases.batch(seed))
    # a one-process checkpoint for the mesh to restore, and the step after it
    cfg = cases.config()
    model = cases.model(cfg)
    state = create_train_state(model, cfg)
    state.model.load_state_dict(refs["tp_sp"]["model"])
    state.opt_state = {"count": 1, **{k: {n: t.clone() for n, t in refs["tp_sp"][k].items()}
                                       for k in ("mu", "nu")}}
    state.step = 1
    CheckpointManager(tmp / "one").save(1, state, epoch=1)
    state, metrics = make_train_step(model, cfg)(state, cases.batch(5), cases.P_TF,
                                                 torch.Generator().manual_seed(1))
    refs["restored_sp"] = cases.result(state, metrics)

    refs["jax"] = _jax_reference(tmp)

    root, out, _ = corpus
    cli_args = {"dist": micro_overrides(root, out, tmp / "exp", *SP_OVERRIDES),
                "one": micro_overrides(root, out, tmp / "exp")}
    mp.start_processes(cases.run, args=(WORLD, _port(), str(tmp), _plan(tmp, refs["jax"]),
                                        cli_args, _port()), nprocs=WORLD, start_method="spawn")
    return tmp, refs


def _load(tmp, name, rank=0):
    return torch.load(tmp / f"{name}_{rank}.pt", weights_only=False)


def _assert_close_trees(got: dict, want: dict, what: str, tol: float = 1e-5):
    assert set(got) == set(want), what
    for k in want:
        err = (got[k].float() - want[k].float()).abs().max().item()
        assert err <= tol, f"{what} {k}: max abs error {err}"


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_step_matches_one_process(pool, name):
    tmp, refs = pool
    got, want = _load(tmp, name), refs[name]
    for key, rel in (("total", 2e-5), ("grad_norm", 2e-4)):
        assert got["metrics"][key] == pytest.approx(want["metrics"][key], rel=rel), key
    for key in ("pred_mel", "post_mel", "stop", "guided_attn"):
        assert got["metrics"][key] == pytest.approx(want["metrics"][key], rel=2e-5), key
    assert got["metrics"]["skipped"] == 0.0 and got["step"] == want["step"]
    _assert_close_trees(got["model"], want["model"], "parameter or BatchNorm statistic")
    _assert_close_trees(got["mu"], want["mu"], "Adam mu")
    _assert_close_trees(got["nu"], want["nu"], "Adam nu")
    if want["ema"] is not None:
        _assert_close_trees(got["ema"], want["ema"], "EMA")


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sharded_step_matches_the_jax_step(pool, name):
    """Dropout off, ``p_tf`` 1: the sharded port step against the JAX step
    on the same batch and weights, at ``tests/test_torch_train_step.py``'s
    tolerances (losses and norm 1e-5; updates element by element where
    Adam's division is well conditioned; Adam moments 1e-3 of the tensor's
    largest entry; BatchNorm statistics 1e-4)."""
    tmp, refs = pool
    ref, got = refs["jax"], _load(tmp, name)
    pcfg = ref["pcfg"]
    for key in ("total", "pred_mel", "post_mel", "stop", "grad_norm"):
        _close(got["metrics"][key], ref["metrics"][key], 1e-5, 1.0, f"{name} {key}")
    assert got["metrics"]["skipped"] == 0.0 and got["step"] == 1
    update = {n: got["model"][n] - ref["before"][n] for n in got["mu"]}
    _close_updates(update, ref["update"], ref["nu"], pcfg, f"{name} update")
    _close_tree(got["mu"], ref["mu"], pcfg, 1e-3, 1e-6, f"{name} mu")
    _close_tree(got["nu"], ref["nu"], pcfg, 1e-3, 1e-9, f"{name} nu")
    for n, want in ref["stats"].items():
        _close(got["model"][n], want.numpy(), 1e-4, 1e-6, f"{name} batch stat {n}")


def test_every_rank_of_a_mesh_holds_the_same_step(pool):
    """(2, 2) + SP: the four ranks' gathered states and metrics agree bit
    for bit."""
    tmp, _ = pool
    runs = [_load(tmp, "dp_tp_sp_ffn", r) for r in range(4)]
    for other in runs[1:]:
        assert other["metrics"] == runs[0]["metrics"]
        for k, v in runs[0]["model"].items():
            assert torch.equal(other["model"][k], v), k


def test_disjoint_data_shards_agree_bit_for_bit(pool):
    """The counterpart of ``tests/test_multihost.py``: two processes, each
    on its own half of the batch, hold bit-equal losses and parameters."""
    tmp, _ = pool
    a, b = _load(tmp, "dp", 0), _load(tmp, "dp", 1)
    assert a["metrics"] == b["metrics"] and np.isfinite(a["metrics"]["total"])
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k


def test_nonfinite_rows_on_one_rank_skip_every_rank(pool):
    tmp, _ = pool
    fresh = cases.model(cases.config()).state_dict()
    for rank in (0, 1):
        got = _load(tmp, "skip", rank)
        assert got["metrics"]["skipped"] == 1.0 and got["step"] == 1
        for k, v in fresh.items():
            assert torch.equal(got["model"][k], v), k


def _block_calls(cfg) -> int:
    """Attention and FFN blocks of the model: one output collective each."""
    m = cfg.model
    return m.encoder_n_layers * 2 + m.decoder_n_layers * 3


def test_collectives_audit_tp_forward(pool):
    """(1, 2): the train-mode forward's all-reduces are one per attention
    block and one per FFN block, and nothing is gathered; its backward has
    one all-reduce per block input (f) and one for the decoder's memory."""
    tmp, _ = pool
    blocks = _block_calls(cases.config())
    got = _load(tmp, "fwd_tp")
    assert got["forward"] == {"all_reduce": blocks}
    assert got["backward"] == {"all_reduce.bwd": blocks + 1}


def test_collectives_audit_sp_gathers_bounded(pool):
    """(1, 2) + SP: a reduce-scatter per block in place of TP's all-reduce,
    and the gathers bounded as the JAX audit bounds them
    (``tests/test_collectives_audit.py:143-179``): one per block, the
    memory once, the two convolution stacks and the go-frame shift's last
    frames, below 3 per attention block + 2."""
    tmp, _ = pool
    cfg = cases.config()
    blocks = _block_calls(cfg)
    m = cfg.model
    got = _load(tmp, "fwd_sp")
    assert got["forward"] == {"all_gather": blocks + 4, "reduce_scatter": blocks}
    assert blocks + 4 <= 3 * (m.encoder_n_layers + 2 * m.decoder_n_layers) + 2
    # the backward: each gather's reduce-scatter (the shift's frames carry no
    # gradient) and each reduce-scatter's gather
    assert got["backward"] == {"reduce_scatter.bwd": blocks + 3, "all_gather.bwd": blocks}


def test_step_collectives_pinned(pool):
    """The whole step's collectives (K = 2 micro-batches, scheduled
    sampling: two forwards and one backward each).

    (1, 2): per micro-batch the two forwards' block all-reduces (2 * 10),
    the guided-attention loss's sum over the model ranks (1) and the
    backward's f all-reduces (10 blocks + the memory); per step one
    all-reduce of the sharded parameters' squared gradient norms.

    (1, 2) + SP: per micro-batch the forwards' gathers (14 with the
    postnet, 13 without: the first pass skips it) and reduce-scatters
    (2 * 10), one all-reduce of the valid-frame count, and the backward's
    13 reduce-scatters and 10 gathers; per step the replicated gradients'
    sum over the model ranks, the metrics' sum and the norm's."""
    tmp, _ = pool
    blocks, k = _block_calls(cases.config()), 2
    assert _load(tmp, "tp")["counts"] == {
        "all_reduce": k * (2 * blocks + 1) + 1, "all_reduce.bwd": k * (blocks + 1)}
    assert _load(tmp, "tp_sp")["counts"] == {
        "all_gather": k * (2 * (blocks + 4) - 1), "reduce_scatter": k * 2 * blocks,
        "all_reduce": k + 3, "reduce_scatter.bwd": k * (blocks + 3),
        "all_gather.bwd": k * blocks}


def test_checkpoint_written_on_a_mesh_restores_on_one_process(pool):
    """(1, 2) -> 1: rank 0 wrote the gathered tensors; one process restores
    them and holds the one-process step's state.  1 -> (1, 2): the
    ``restored_sp`` case restored a one-process checkpoint on the mesh."""
    tmp, refs = pool
    cfg = cases.config(ema=0.99)
    state, epoch = CheckpointManager(tmp / "saved_tp").restore(
        create_train_state(cases.model(cfg), cfg))
    assert epoch == 1 and state.step == 1 and state.opt_state["count"] == 1
    want = refs["tp"]
    _assert_close_trees(state.model.state_dict(), want["model"], "restored tensor")
    _assert_close_trees(state.ema_params, want["ema"], "restored EMA")
    _assert_close_trees(state.opt_state["mu"], want["mu"], "restored mu")


def test_cli_train_distributed_matches_one_process(pool):
    """``cli train --distributed --device cpu`` over 2 gloo processes at
    (1, 2) + SP: rank 0 alone wrote ``history.json`` and the checkpoints,
    and the epochs' losses and validation equal the one-process run's."""
    tmp, _ = pool
    dist_run, one_run = tmp / "exp" / "dist", tmp / "exp" / "one"
    hist = json.loads((dist_run / "history.json").read_text())
    ref = json.loads((one_run / "history.json").read_text())
    assert len(hist) == len(ref) == 2
    for got, want in zip(hist, ref):
        for key in ("total", "grad_norm", "val_loss", "val_mel_l1", "val_free_mel_l1"):
            assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-6), key
    assert CheckpointManager(dist_run / "checkpoints").all_steps() == \
        CheckpointManager(one_run / "checkpoints").all_steps()
    assert (tmp / "cli_0.log").read_text().count("done: best val loss") == 1
    assert "done" not in (tmp / "cli_1.log").read_text()


def test_dryrun_multichip_on_four_cpu_processes(capfd):
    dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip(4): mesh=(2 data x 2 model + seq-parallel) over gloo" in \
        capfd.readouterr().out


@pytest.mark.parametrize("which", ["Config()", "large_tp.yaml"])
def test_param_spec_matches_the_jax_rules(which):
    """Name by name over every parameter: the port's spec is the JAX spec of
    the flax leaf after the (in, out) -> (out, in) transpose (an embedding
    is not transposed and its spec is symmetric)."""
    jcfg = JaxConfig() if which == "Config()" else jax_load_config(LARGE_TP)
    pcfg = Config() if which == "Config()" else load_config(LARGE_TP)
    shapes = jax.eval_shape(
        lambda: JaxTTS(jcfg.model).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8, jcfg.model.n_mels)),
            jnp.array([8]), jnp.array([8]), train=False))["params"]
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    names = {k for k, _ in TransformerTTS(pcfg.model, device="meta").named_parameters()}
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
    mapped = set()
    for path, arr in leaves:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + [leaf.get(keys[-1], keys[-1])])
        spec = tuple(jax_param_spec("/".join(keys), tp=True))
        if keys[-1] == "kernel" and spec:
            spec = tuple(reversed(spec))
        assert param_spec(name, tp=True) == spec, name
        assert param_spec(name, tp=False) == ()
        mapped.add(name)
    assert mapped == names
    # q, k, v weights and biases and the out-projection weight of every
    # attention; Dense_0's weight and bias and Dense_1's weight of every FFN
    m = pcfg.model
    n_attn = m.encoder_n_layers + 2 * m.decoder_n_layers
    n_ffn = m.encoder_n_layers + m.decoder_n_layers
    assert sum("model" in param_spec(n, True) for n in names) == 7 * n_attn + 3 * n_ffn


def test_make_mesh_and_shard_batch_refuse_what_does_not_split():
    with pytest.raises(ValueError, match="needs 2 processes, it has 1"):
        make_mesh(2, 1)
    assert make_mesh().size == 1
    batch = cases.batch(0, k=1, b=4, tm=64)
    with pytest.raises(ValueError, match="batch axis of 4 does not split over 3 data"):
        shard_batch(batch, Mesh(3, 1, 0, 0))
    with pytest.raises(ValueError, match="phoneme: time axis of 16 does not split over 3 model"):
        shard_batch(batch, Mesh(1, 3, 0, 0), shard_sequence=True)
    part = shard_batch(batch, Mesh(2, 2, 1, 1), shard_sequence=True)
    assert torch.equal(part["melspec"], torch.as_tensor(batch["melspec"])[:, 2:4, 32:64])
    assert torch.equal(part["phoneme_lens"], torch.as_tensor(batch["phoneme_lens"])[:, 2:4])


# --- the kernels' plain versions with mask offsets: the one-device call, sliced ---

def test_flash_mask_offsets_give_the_whole_calls_rows_and_heads():
    g = torch.Generator().manual_seed(0)
    b, t, h, d = 4, 96, 4, 32
    q, k, v = (torch.randn(b, t, h, d, generator=g) for _ in range(3))
    bias = torch.zeros(b, t)
    block_q = fa.pick_block(t, t)
    keep = fa._keep((b, h, t, t), 7, 0.3, block_q, "cpu")
    assert torch.equal(fa._keep((2, 2, t, t), 7, 0.3, block_q, "cpu", (2, h, 1)),
                       keep[2:4, 1:3])
    whole = fa.flash_attention(q, k, v, bias, causal=True, dropout=0.3, seed=7)
    part = fa.flash_attention(q[2:4, :, 1:3], k[2:4, :, 1:3], v[2:4, :, 1:3], bias[2:4],
                              causal=True, dropout=0.3, seed=7, mask_bh=(2, h, 1))
    torch.testing.assert_close(part, whole[2:4, :, 1:3], rtol=0, atol=1e-6)
    dout = torch.randn(b, t, h, d, generator=g)
    q_part = q[2:4, :, 1:3].clone().requires_grad_()
    q_whole = q.clone().requires_grad_()
    fa.flash_attention(q_whole, k, v, bias, causal=True, dropout=0.3, seed=7).backward(dout)
    fa.flash_attention(q_part, k[2:4, :, 1:3], v[2:4, :, 1:3], bias[2:4], causal=True,
                       dropout=0.3, seed=7, mask_bh=(2, h, 1)).backward(dout[2:4, :, 1:3])
    torch.testing.assert_close(q_part.grad, q_whole.grad[2:4, :, 1:3], rtol=0, atol=1e-6)


def test_ln_row_map_gives_the_whole_calls_rows():
    g = torch.Generator().manual_seed(1)
    b, t, dm = 4, 64, 32
    x, h = torch.randn(b, t, dm, generator=g), torch.randn(b, t, dm, generator=g)
    gamma, beta = torch.randn(dm, generator=g), torch.randn(dm, generator=g)
    # mask blocks of 16 rows; rows 2-3 of the batch, time slice 32-63: the
    # part a (2, 2) + SP mesh gives data rank 1, model rank 1
    row_map = (32, t, 2 * t + 32)
    keep = ln._z_and_stats(x.reshape(-1, dm), h.reshape(-1, dm), 9, 0.4, 1e-5, 16)[3]
    keep_part = ln._z_and_stats(x[2:4, 32:].reshape(-1, dm), h[2:4, 32:].reshape(-1, dm), 9,
                                0.4, 1e-5, 16, row_map)[3]
    assert torch.equal(keep_part, keep.reshape(b, t, dm)[2:4, 32:].reshape(-1, dm))
    whole = ln.residual_dropout_layernorm(x, h, gamma, beta, dropout=0.4, seed=9,
                                          mask_rows=16)
    part = ln.residual_dropout_layernorm(x[2:4, 32:], h[2:4, 32:], gamma, beta, dropout=0.4,
                                         seed=9, mask_rows=16, row_map=row_map)
    torch.testing.assert_close(part, whole[2:4, 32:], rtol=0, atol=1e-6)
    dh_whole = ln.residual_dropout_layernorm_backward_reference(
        x.reshape(-1, dm), h.reshape(-1, dm), gamma, torch.ones(b * t, dm), 9, 0.4, 1e-5, 16)[1]
    dh_part = ln.residual_dropout_layernorm_backward_reference(
        x[2:4, 32:].reshape(-1, dm), h[2:4, 32:].reshape(-1, dm), gamma, torch.ones(64, dm), 9,
        0.4, 1e-5, 16, row_map)[1]
    torch.testing.assert_close(dh_part, dh_whole.reshape(b, t, dm)[2:4, 32:].reshape(-1, dm),
                               rtol=0, atol=1e-6)


def test_ffn_column_and_row_maps_sum_to_the_whole_call():
    g = torch.Generator().manual_seed(2)
    n, dm, f = 96, 32, 64
    x = torch.randn(n, dm, generator=g)
    w1, b1 = torch.randn(f, dm, generator=g) * 0.2, torch.randn(f, generator=g)
    w2, b2 = torch.randn(dm, f, generator=g) * 0.2, torch.randn(dm, generator=g)
    whole = ffn.fused_ffn(x, w1, b1, w2, b2, dropout=0.3, seed=4, mask_rows=32)
    # rows 48-95 (the second data rank), d_ffn split over two model ranks
    parts = [ffn.fused_ffn(x[48:], w1[c:c + 32], b1[c:c + 32], w2[:, c:c + 32],
                           torch.zeros(dm), dropout=0.3, seed=4, mask_rows=32,
                           row_map=(48, 48, 48), col_map=(f, c)) for c in (0, 32)]
    torch.testing.assert_close(parts[0] + parts[1] + b2, whole[48:], rtol=0, atol=1e-5)
    keep_whole = ffn._hidden(x, w1, b1, 4, 0.3, 32)[2]
    keep_part = ffn._hidden(x[48:], w1[32:], b1[32:], 4, 0.3, 32, (48, 48, 48), (f, 32))[2]
    assert torch.equal(keep_part, keep_whole[48:, 32:])
