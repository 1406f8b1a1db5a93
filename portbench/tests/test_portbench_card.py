"""On the chip, at each cell's own sizes: the control (the plain reference
in float8, the precision below the configurations' bf16, put in the
program's place) comes out not correct on three seeds, and the program
correct.  Run from a checkout's root on a machine with the card:
``python -m pytest portbench/tests -q -m card``."""

import pytest

from portbench import harness

CELLS = ["ljspeech.serve-poisson", "paper.train-buckets", "ljspeech.stream-b1",
         "paper.serve-backlog"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cuda_device, cell):
    limits = harness.cell_spec(cell)["params"]["limits"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        rec = harness.run_cell(cell, seed, 8.0, False, cuda_device, control=True)
        assert all(c["ok"] for c in rec["checks"].values()), (seed, rec["checks"])
        assert any(rec["control"][k] > limit for k, limit in limits.items()), (seed, rec["control"])
        harness.free_device()
