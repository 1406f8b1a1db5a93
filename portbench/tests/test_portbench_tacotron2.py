"""The Tacotron 2 cell (``tacotron2.serve-backlog``, kind ``t2_backlog``): a
whole run of the new kind on the CPU at a small size through
``harness.run_cell`` (``correct`` true), each planted fault turning
``correct`` false, the new configuration and cell against
``BENCHMARK.json``'s contract, and the step's bytes and operations
(``counts_tacotron2.py``)."""

import copy
import json

import pytest
import torch

from portbench import counts_tacotron2, faults, harness
from portbench.reference.tacotron2_weights import param_shapes, step_params

SMALL = dict(symbols_embedding_dim=64, encoder_embedding_dim=64, attention_rnn_dim=128,
             decoder_rnn_dim=128, prenet_dim=32, attention_dim=16, attention_location_n_filters=4,
             postnet_embedding_dim=64)
NVIDIA = {"symbols_embedding_dim": 512, "encoder_n_convolutions": 3, "encoder_kernel_size": 5,
          "encoder_embedding_dim": 512, "attention_rnn_dim": 1024, "decoder_rnn_dim": 1024,
          "prenet_dim": 256, "attention_dim": 128, "attention_location_n_filters": 32,
          "attention_location_kernel_size": 31, "postnet_embedding_dim": 512,
          "postnet_n_layers": 5, "postnet_kernel_size": 5, "n_mels": 80, "reduction_factor": 1}
# NVIDIA's gate_threshold and max_decoder_steps, as the program's runtime keys
NVIDIA_RUNTIME = {"stop_threshold": 0.5, "infer_max_len": 1000}
CELL = "tacotron2.serve-backlog"


def small_run(seed=2**31 + 31):
    c = copy.deepcopy(harness.config_spec("tacotron2"))
    c["model"].update(SMALL)
    c["runtime"].update(compute_dtype="float32", phoneme_buckets=[96, 192])
    cell = copy.deepcopy(harness.cell_spec(CELL))
    # the checked requests among the first 12: served within the window on a loaded CPU too
    cell["params"].update(frames=24, max_batch=4, clients=4, pool=3000, check_among=12,
                          n_checked=6)
    rec = harness.run_cell(CELL, seed, 2.0, False, device="cpu", config_override=c,
                           cell_override=cell)
    return rec, harness.result_line(CELL, rec, False, torch.device("cpu"))


@pytest.mark.parametrize("fault", [None, "unchanged", "altered", "half"])
def test_a_small_run_is_correct_and_each_fault_is_not(fault):
    undo = faults.plant(fault, training=False) if fault else (lambda: None)
    try:
        rec, out = small_run()
    finally:
        undo()
    assert out["correct"] is (fault is None), {k: c["value"] for k, c in out["checks"].items()}
    assert rec["frames_in_window"] > 0 and rec["failed"] == 0
    assert set(out["metrics"]) == {"serve_frames_per_s", "setup_s"}
    if fault is None:
        assert out["checks"]["frame_gap"]["value"] < 1e-5


def test_the_new_configuration_keeps_nvidias_widths():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == "tacotron2")
    assert entry["reduced"] == ["n_symbols"] and entry["source"].startswith(
        "https://github.com/NVIDIA/tacotron2")
    conf = harness.config_spec("tacotron2")
    assert conf["source"] == entry["source"] and conf["reduced"] == entry["reduced"]
    assert {k: conf["model"][k] for k in NVIDIA} == NVIDIA
    assert conf["model"]["architecture"] == "tacotron2"
    assert conf["audio"] == harness.config_spec("ljspeech")["audio"]
    assert conf["runtime"]["infer_prenet_dropout"] == 0.5
    assert {k: conf["runtime"][k] for k in NVIDIA_RUNTIME} == NVIDIA_RUNTIME
    # 28.2 M parameters (NVIDIA's 148-symbol embedding holds 48 more rows than n_phon 100)
    n = sum(int(torch.Size(s).numel()) for k, s in param_shapes(conf["model"]).items()
            if "running_" not in k)
    assert abs(n + 48 * 512 - 28.2e6) < 0.1e6


@pytest.mark.parametrize("cell, metric, e2e", [
    ("tacotron2.serve-backlog", "t2_backlog", "serve_frames_per_s")])
def test_the_new_cells_keep_to_the_contract(cell, metric, e2e):
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    w = next(x for x in spec["workloads"] if x["name"] == cell)
    spec_cell = harness.cell_spec(cell)
    assert w["chips"] == 1 and (w["config"], w["traffic"]) == (spec_cell["config"],
                                                              spec_cell["traffic"])
    e = next(x for x in spec["end_to_end"] if x["name"] == e2e)
    assert cell in e["workloads"]
    names = [m["name"] for m in harness.cell_metrics(spec, cell, True)]
    assert names and all(n.endswith("." + metric) for n in names)
    for n in names:
        assert callable(harness.reader(n).read)
    assert {m["name"] for m in harness.cell_metrics(spec, cell, False)} == {e2e, "setup_s"}


def test_the_roofline_reads_only_the_steps_launches():
    read = harness.reader("tacotron2_step.roofline.t2_backlog").read
    assert read({}) is None
    prof = {"t2_bound_s": 1e-3, "by_name": {
        "void (anonymous namespace)::tacotron2_step_lstm<8>(...)": [2e-3, 10],
        "(anonymous namespace)::tacotron2_step_energy(...)": [2e-3, 5],
        "void decode_step_kernel<1>": [5.0, 1]}}
    assert read({"profile": prof}) == pytest.approx(25.0)


def test_step_counts():
    m = harness.config_spec("tacotron2")["model"]
    assert step_params(m) == 18_189_969
    nbytes, flops = counts_tacotron2.step_bytes_flops(m, 8, 192)
    assert 38.5e6 < nbytes < 38.8e6 and 0.30e9 < flops < 0.32e9  # ~11.5 us at 3.35 TB/s
    assert counts_tacotron2.step_bound_s(m, 8, 192) == pytest.approx(nbytes / 3.35e12)
    assert counts_tacotron2.decode_bound_s(m, 8, 192, 576) == pytest.approx(
        576 * nbytes / 3.35e12)
