"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points need CUDA unless the caller names the CPU, and the weight
bridge refuses trees that do not fit the model."""

import ast
import copy
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_models import configs, jax_model_and_variables
from transformertts_tpu_torch.convert import torch_state_from_jax
from transformertts_tpu_torch.dsp.griffin_lim import griffin_lim
from transformertts_tpu_torch.infer import Synthesizer, make_decode_fn
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "transformertts_tpu")
SOURCES = sorted((ROOT / "transformertts_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _imported_names(path: Path) -> list:
    return [a.asname or a.name for node in ast.walk(ast.parse(path.read_text(), str(path)))
            if isinstance(node, ast.ImportFrom) for a in node.names]


# every __init__.py of the JAX package that exports names
EXPORTING = [p for p in sorted((ROOT / "transformertts_tpu").rglob("__init__.py"))
             if _imported_names(p)]
# counterparts under another name or module: a name that says its framework,
# and the Pallas kernels' entries, whose CUDA counterparts live in ``ops/``
COUNTERPART = {
    ("transformertts_tpu.dsp", "mel_spectrogram_jax"):
        ("transformertts_tpu_torch.dsp", "mel_spectrogram_torch"),
    ("transformertts_tpu.ops.pallas", "flash_attention"):
        ("transformertts_tpu_torch.ops.flash_attention", "flash_attention"),
    ("transformertts_tpu.ops.pallas", "log_mel_pallas"):
        ("transformertts_tpu_torch.ops.stft", "log_mel"),
}


@pytest.mark.parametrize("init", EXPORTING, ids=lambda p: str(p.parent.relative_to(ROOT)))
def test_port_exports_what_the_jax_package_exports(init):
    """Each name a JAX ``__init__.py`` imports can be imported from the
    port's counterpart package (``COUNTERPART``: from another module or under
    another name)."""
    jax_mod = ".".join(init.parent.relative_to(ROOT).parts)
    missing = []
    for name in _imported_names(init):
        default = (jax_mod.replace("transformertts_tpu", "transformertts_tpu_torch", 1), name)
        module, port_name = COUNTERPART.get((jax_mod, name), default)
        if not hasattr(importlib.import_module(module), port_name):
            missing.append(f"{module}.{port_name}")
    assert not missing, f"the port lacks {missing}"


def test_the_jax_packages_exporting_are_found():
    names = {str(p.parent.relative_to(ROOT)) for p in EXPORTING}
    assert {"transformertts_tpu", "transformertts_tpu/infer", "transformertts_tpu/parallel",
            "transformertts_tpu/train", "transformertts_tpu/models",
            "transformertts_tpu/native"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_native_reader_reads_nothing_of_the_jax_package():
    """The port's reader builds from its own source into its own build
    directory, and no string of its code names a path of the JAX package."""
    from transformertts_tpu_torch import _build

    port = ROOT / "transformertts_tpu_torch"
    native = sorted((port / "native").iterdir())
    assert {p.name for p in native} >= {"__init__.py", "bindings.py", "npz_loader.cpp"}
    assert _build.NATIVE == port / "native" and _build.BUILD_DIR == port / "_build"
    assert _build.host_library_path("npz_loader").parent == port / "_build"
    for path in [*native, port / "_build.py"]:
        if path.suffix in (".py", ".cpp"):
            text = path.read_text()
            assert "transformertts_tpu/" not in text and "transformertts_tpu\"" not in text
            assert "TTS_NATIVE_CACHE" not in text, path.name
    strings = [n.value for n in ast.walk(ast.parse((port / "native" / "bindings.py").read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not [s for s in strings if "transformertts_tpu" in s and "_torch" not in s]


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"decode_step.py", "api.py", "serving.py", "chip_smoke.py", "g2p.py", "fused_ffn.py",
            "stft.py", "mel.py", "preprocess.py", "dataset.py", "prefetch.py",
            "audio_io.py", "trainer.py", "checkpoint.py", "griffin_lim.py", "cli.py",
            "logging.py", "exp.py", "plot.py", "bindings.py"} <= names


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pcfg = configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerTTS(pcfg.model)
    model = TransformerTTS(pcfg.model, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_decode_fn(model, pcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Synthesizer(pcfg, state_dict=model.state_dict())
    assert make_decode_fn(model, pcfg, device="cpu") is not None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(pcfg, "unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        griffin_lim(np.zeros((80, 4), np.float32))


def test_chip_smoke_fails_without_cuda():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_convert_refuses_missing_and_extra_leaves():
    jcfg, pcfg = configs()
    variables = jax_model_and_variables(jcfg)[1]
    state = torch_state_from_jax(variables, pcfg.model)
    assert set(state) == set(TransformerTTS(pcfg.model, device="meta").state_dict())

    missing = copy.deepcopy(variables)
    del missing["params"]["decoder"]["layer_1"]["norm3"]
    with pytest.raises(ValueError, match="missing"):
        torch_state_from_jax(missing, pcfg.model)

    extra = copy.deepcopy(variables)
    extra["params"]["decoder"]["layer_2"] = extra["params"]["decoder"]["layer_1"]
    with pytest.raises(ValueError, match="unused leaf"):
        torch_state_from_jax(extra, pcfg.model)

    bad_shape = copy.deepcopy(variables)
    bad_shape["params"]["pe"]["alpha"] = np.ones((2,), np.float32)
    with pytest.raises(ValueError, match="unused leaf"):
        torch_state_from_jax(bad_shape, pcfg.model)


def test_convert_layouts():
    """Dense kernels (in, out) -> (out, in); Conv kernels (k, in, out) ->
    (out, in, k); BatchNorm statistics to running buffers as they are."""
    jcfg, pcfg = configs()
    variables = jax_model_and_variables(jcfg)[1]
    state = torch_state_from_jax(variables, pcfg.model)
    p, s = variables["params"], variables["batch_stats"]
    dense = p["decoder"]["layer_0"]["ffn"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(state["decoder.layer_0.ffn.Dense_0.weight"].numpy(), dense.T)
    conv = p["postnet"]["ConvBN_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(state["postnet.ConvBN_0.Conv_0.weight"].numpy(),
                                  conv.transpose(2, 1, 0))
    np.testing.assert_array_equal(state["enc_prenet.ConvBN_1.BatchNorm_0.running_var"].numpy(),
                                  s["enc_prenet"]["ConvBN_1"]["BatchNorm_0"]["var"])
    assert state["pe.alpha"].shape == (1,)


@pytest.mark.parametrize("module", ["ops.flash_attention", "ops.fused_ln", "ops.dropout_mask",
                                    "train.train_step", "models.factory", "ops.fused_ffn",
                                    "ops.stft", "dsp.mel", "data.preprocess", "data.dataset",
                                    "data.prefetch", "train.trainer", "train.checkpoint",
                                    "dsp.griffin_lim", "cli", "utils.plot", "infer.api",
                                    "native"])
def test_each_module_imports_first(module):
    """No import cycle: any module of the training and data slices can be the first
    one a fresh interpreter imports (``models`` imports ``ops``, so ``ops``
    must not import ``models`` at import time)."""
    proc = subprocess.run(
        [sys.executable, "-c", f"import transformertts_tpu_torch.{module}"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_plots_import_matplotlib_only_when_drawn():
    """A machine without matplotlib trains: importing the trainer (and its
    plot module) does not import it."""
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, transformertts_tpu_torch.train.trainer; "
         "assert 'matplotlib' not in sys.modules"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
