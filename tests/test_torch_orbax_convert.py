"""``tools/orbax_to_torch.py``: orbax checkpoints of the JAX package into the
port's checkpoint format, and the port's ``cli synthesize`` against the JAX
CLI's on the same weights.

Three tiny orbax checkpoints are written with the JAX ``CheckpointManager``:
one with an EMA copy, one without, and one of ``runtime.fused_optimizer``
(Adam's moments as one flat vector), every tensor seeded (parameters,
BatchNorm statistics, Adam's moments, the EMA copy), Adam's count and the
step 7, the epoch 3.  The conversion must copy every one of them exactly
(a conversion only transposes).  Decodes of the converted checkpoint are
held against the JAX decode of the orbax state's ``eval_params`` within
``tests/test_torch_decode.py``'s 1e-4 * max(1, max|jax|) (fp32).
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_models import assert_close, randomize
from transformertts_tpu import cli as jax_cli
from transformertts_tpu.config import load_config as jax_load_config
from transformertts_tpu.infer.decode import make_decode_fn as jax_make_decode_fn
from transformertts_tpu.models import TransformerTTS as JaxTTS
from transformertts_tpu.train.checkpoint import CheckpointManager as OrbaxManager
from transformertts_tpu.train.train_step import create_train_state as jax_train_state
from transformertts_tpu_torch import cli
from transformertts_tpu_torch.config import load_config
from transformertts_tpu_torch.convert import torch_state_from_jax, torch_tree_from_jax
from transformertts_tpu_torch.infer import Synthesizer
from transformertts_tpu_torch.infer.decode import make_decode_fn
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.train.checkpoint import CheckpointManager
from transformertts_tpu_torch.train.train_step import create_train_state

ROOT = Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "orbax_to_torch.py"
TOL = 1e-4
SETS = ["model.d_model=64", "model.encoder_n_layers=1", "model.decoder_n_layers=1",
        "model.encoder_d_ffn=128", "model.decoder_d_ffn=128", "model.postnet_n_layers=2",
        "runtime.compute_dtype=float32", "runtime.phoneme_buckets=[16,32]",
        "runtime.infer_max_len=12", "runtime.stop_threshold=2.0"]
TEXT = "Hello world."  # 10 phonemes: the smallest bucket is 16, the largest 32


def _tool():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _seeded(state, seed: int):
    """Every tensor of a JAX TrainState random; Adam's count and the step 7.
    Returns the state and Adam's moments as params-shaped trees (flattened
    in ``jax.tree`` order into the state, as ``optax.flatten`` keeps them,
    where the optimizer is fused)."""
    rng = np.random.default_rng(seed)

    def rand(scale, positive=False):
        return jax.tree.map(lambda x: (np.abs if positive else np.asarray)(
            scale * rng.standard_normal(np.shape(x))).astype(np.float32), state.params)

    var = randomize({"params": state.params, "batch_stats": state.batch_stats}, seed)
    opt = list(state.opt_state)
    adam = opt[2]
    moments = rand(0.1), rand(1e-3, positive=True)
    flat = [np.concatenate([np.ravel(x) for x in jax.tree.leaves(m)]) for m in moments]
    fused = np.ndim(adam.mu) == 1
    opt[2] = adam._replace(count=np.asarray(7, np.int32), **dict(zip(
        ("mu", "nu"), flat if fused else moments)))
    ema = None
    if state.ema_params is not None:
        ema = jax.tree.map(lambda p: p + 0.01 * rng.standard_normal(p.shape).astype(np.float32),
                           var["params"])
    return state.replace(step=np.asarray(7, np.int32), params=var["params"],
                         batch_stats=var["batch_stats"], opt_state=tuple(opt),
                         ema_params=ema), moments


@pytest.fixture(scope="module")
def orbax(tmp_path_factory):
    """{"ema" | "none" | "fused": (orbax directory, JAX state, Adam's
    moments as trees)} and the overrides."""
    root = tmp_path_factory.mktemp("orbax")
    (root / "prep").mkdir()
    (root / "prep" / "stats.json").write_text(json.dumps({"mean": -5.0, "std": 2.0}))
    sets = [f"path.preprocessed={root / 'prep'}", *SETS]
    example = {"phoneme": np.zeros((1, 1, 16), np.int32),
               "melspec": np.zeros((1, 1, 32, 80), np.float32),
               "phoneme_lens": np.full((1, 1), 16, np.int32),
               "melspec_lens": np.full((1, 1), 32, np.int32)}
    out = {}
    for seed, (name, extra) in enumerate((("none", []), ("ema", ["training.ema_decay=0.9"]),
                                          ("fused", ["runtime.fused_optimizer=true"]))):
        jcfg = jax_load_config(None, [*sets, *extra])
        state, moments = _seeded(jax_train_state(JaxTTS(jcfg.model), jcfg,
                                                 jax.random.PRNGKey(0), example), seed)
        mgr = OrbaxManager(root / name)
        mgr.save(7, state, epoch=3)
        mgr.close()
        out[name] = (root / name, jax.device_get(state), moments)
    return out, sets, root


@pytest.fixture(scope="module")
def converted(orbax):
    """The EMA checkpoint converted by the tool's command line (``main``),
    the others by its ``convert`` function."""
    dirs, sets, root = orbax
    tool = _tool()
    assert tool.main([str(dirs["ema"][0]), str(root / "torch_ema"),
                      *[a for s in sets for a in ("--set", s)]]) == 0
    assert tool.convert(dirs["none"][0], root / "torch_none", None, sets) == (7, 3)
    assert tool.convert(dirs["fused"][0], root / "torch_fused", None,
                        [*sets, "runtime.fused_optimizer=true"]) == (7, 3)
    return {name: root / f"torch_{name}" for name in dirs}


@pytest.mark.parametrize("name", ["ema", "none", "fused"])
def test_conversion_copies_every_tensor_exactly(orbax, converted, name):
    dirs, sets, _ = orbax
    _, src, (mu, nu) = dirs[name]
    cfg = load_config(None, sets)
    restored, epoch = CheckpointManager(converted[name]).restore(
        create_train_state(TransformerTTS(cfg.model, device="cpu"), cfg), adopt_ema=True)
    meta = json.loads((converted[name] / "7" / "meta.json").read_text())
    assert (restored.step, restored.opt_state["count"], epoch) == (7, 7, 3)
    assert meta["has_ema"] is (name == "ema")

    def equal(ours: dict, ref: dict, what):
        assert set(ours) == set(ref), what
        for k in ref:
            assert torch.equal(ours[k], ref[k]), f"{what} {k}"

    equal(restored.model.state_dict(), torch_state_from_jax(
        {"params": src.params, "batch_stats": src.batch_stats}, cfg.model), "state")
    equal(restored.opt_state["mu"], torch_tree_from_jax(mu, cfg.model), "mu")
    equal(restored.opt_state["nu"], torch_tree_from_jax(nu, cfg.model), "nu")
    if name == "ema":
        equal(restored.ema_params, torch_tree_from_jax(src.ema_params, cfg.model), "ema")
        assert not torch.equal(restored.ema_params["emb.weight"],
                               restored.model.emb.weight)
    else:
        assert restored.ema_params is None


def test_synthesizer_on_converted_equals_jax_decode(orbax, converted):
    dirs, sets, _ = orbax
    src = dirs["ema"][1]
    jcfg, cfg = jax_load_config(None, sets), load_config(None, sets)
    synth = Synthesizer(cfg, checkpoint_dir=converted["ema"], device="cpu")
    rng = np.random.default_rng(0)
    phoneme, lens = rng.integers(1, 60, (2, 16)).astype(np.int32), np.array([16, 9], np.int32)
    ref = jax.device_get(jax_make_decode_fn(JaxTTS(jcfg.model), jcfg)(
        {"params": src.eval_params, "batch_stats": src.batch_stats}, phoneme, lens))
    ours = make_decode_fn(synth.model, cfg, device="cpu")(phoneme, lens)
    assert ours["n_frames"] == int(ref["n_frames"]) == 12
    for k in ("pred_melspec", "post_melspec", "pred_stop"):
        assert_close(ours[k], ref[k], TOL, k)


def test_cli_synthesize_matches_the_jax_cli(orbax, converted, tmp_path, capsys):
    """The JAX CLI pads the phonemes to the largest bucket and cuts the mel
    at the global frame count; the port's CLI decodes the same."""
    dirs, sets, _ = orbax
    args = [a for s in sets for a in ("--set", s)]
    jax_cli.main(["synthesize", "--ckpt", str(dirs["ema"][0]), "--text", TEXT,
                  "--out", str(tmp_path / "jax.npy"), *args])
    cli.main(["synthesize", "--ckpt", str(converted["ema"]), "--text", TEXT,
              "--out", str(tmp_path / "port.npy"), "--device", "cpu", *args])
    ref, ours = np.load(tmp_path / "jax.npy"), np.load(tmp_path / "port.npy")
    assert ours.shape == ref.shape == (80, 12)
    assert_close(ours, ref, TOL, "cli synthesize mel")
    assert capsys.readouterr().out.count("wrote 12 frames") == 2


def test_port_names_the_converter_for_an_orbax_directory(orbax):
    dirs, sets, _ = orbax
    with pytest.raises(NotImplementedError, match="tools/orbax_to_torch.py"):
        Synthesizer(load_config(None, sets), checkpoint_dir=dirs["none"][0], device="cpu")


def test_converter_refuses_a_model_the_tree_does_not_fit(orbax, tmp_path):
    dirs, sets, _ = orbax
    with pytest.raises(ValueError):
        _tool().convert(dirs["none"][0], tmp_path / "out", None, [*sets, "model.n_mels=40"])
    with pytest.raises(FileNotFoundError):
        _tool().convert(tmp_path / "missing", tmp_path / "out", None, sets)
    assert not (tmp_path / "out").exists() or not any((tmp_path / "out").iterdir())
