"""A run without the chip, at a tiny configuration on the CPU, with the
timed path broken underneath: ``correct`` has to come out false for each
fault the cell can have, and true without one.  (One chip: no exchange
between chips to leave out.)"""

import copy

import pytest
import torch

from portbench import faults, harness
from portbench.tests.test_portbench_reference import TINY


def tiny_config(name):
    c = copy.deepcopy(harness.config_spec(name))
    c["model"].update(TINY)
    c["runtime"].update(compute_dtype="float32")
    c["training"].update(batch_size=4, grad_acc_steps=2)
    return c


def serve_cell():
    cell = copy.deepcopy(harness.cell_spec("ljspeech.serve-poisson"))
    cell["params"].update(rate_per_s=20.0, frames=64, n_checked=12)
    return cell


def train_cell():
    cell = copy.deepcopy(harness.cell_spec("paper.train-buckets"))
    cell["params"].update(clips=48, frames=[200, 20, 160, 250], n_checked=2)
    return cell


def correct(name, cell, config) -> bool:
    rec = harness.run_cell(name, 2**31 + 21, 2.0, False, device="cpu", config_override=config,
                           cell_override=cell)
    out = harness.result_line(name, rec, False, torch.device("cpu"),
                              {"end_to_end": [], "per_layer": [], "workloads": []})
    return out["correct"]


@pytest.mark.parametrize("fault", [None, "unchanged", "altered", "half"])
def test_serving_faults(fault):
    undo = faults.plant(fault, training=False) if fault else (lambda: None)
    try:
        got = correct("ljspeech.serve-poisson", serve_cell(), tiny_config("ljspeech"))
    finally:
        undo()
    assert got is (fault is None)


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_training_faults(fault):
    undo = faults.plant(fault, training=True) if fault else (lambda: None)
    try:
        got = correct("paper.train-buckets", train_cell(), tiny_config("paper"))
    finally:
        undo()
    assert got is (fault is None)
