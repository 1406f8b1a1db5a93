"""Forced stop votes for the tests of the decode loop's late readback.

A decode runs with each row voting after a step chosen by the test: the
step writes ``VOTE`` as the row's first stop logit of that step and sets
the row's vote, as a stop head that fired.  The same decode runs with the
votes read back after every step (``decode.LAG`` 1) and ``LAG`` steps late;
the two results must be equal bit for bit, and the ``decode.loop`` spans
must count the host's waits and the steps rolled back as ``lag_counts``
says.
"""

import time

import torch

from transformertts_tpu_torch.infer import decode
from transformertts_tpu_torch.models.masks import NEG_INF
from transformertts_tpu_torch.utils import trace

VOTE = 50.0  # sigmoid rounds it to 1.0 in fp32: a vote at any threshold <= 1
THRESHOLD = 1.0  # no unforced logit of a seeded small model reaches it (~17)
RESULT_KEYS = ("pred_melspec", "post_melspec", "pred_stop", "n_frames_per_row")


def last_votes():
    """Steps after which the last row votes: every offset 0 .. 2 ``LAG``
    inside the lag window."""
    return list(range(2 * decode.LAG + 1))


def vote_steps(b: int, last):
    """Step after which each of b rows votes: row b - 1 at ``last``, the
    others earlier (row i at 5 i mod (last + 1)); None: no row votes."""
    if last is None:
        return [None] * b
    return [(5 * i) % (last + 1) for i in range(b - 1)] + [last]


def chunk_stop(votes, rows: slice):
    """The step after which every row of ``rows`` has voted, or None."""
    part = votes[rows]
    return None if None in part else max(part)


def lag_counts(n: int, stop, lag: int) -> tuple:
    """(steps run, host waits) of one loop of at most n steps whose rows
    have all voted after its step ``stop`` (None: not within the loop).
    The host waits after every ``lag``-th step from the second on, for the
    votes ``lag`` steps back, and once more at the end unless a wait found
    the stop."""
    if n <= 0:
        return 0, 0
    if stop is not None and lag * (stop // lag + 2) <= n:
        return lag * (stop // lag + 2), stop // lag + 1
    return n, max(n // lag - 1, 0) + 1


def decode_with_votes(monkeypatch, lag: int, votes, fn) -> tuple:
    """``fn()`` with ``decode.LAG`` = lag and row i voting after its step
    ``votes[i]``; returns (fn's result, its ``decode.loop`` spans, the rows'
    steps run, summed over the chunks of rows)."""
    calls = [0]
    orig = decode.DecodeRows.step

    def step(self):
        t = self.t
        orig(self)
        calls[0] += 1
        for i in range(self.b):
            if votes[self.row0 + i] == t:
                self.stops[i, t * self.r] = VOTE
                self.votes[t, i] = True

    threads = torch.get_num_threads()
    # many small operations: one thread each keeps them from contending with
    # the other test workers' threads (8x slower on a loaded machine)
    torch.set_num_threads(1)
    try:
        with monkeypatch.context() as m:
            m.setattr(decode, "LAG", lag)
            m.setattr(decode.DecodeRows, "step", step)
            t0 = time.perf_counter_ns()
            out = fn()
    finally:
        torch.set_num_threads(threads)
    loops = [s for s in trace.spans() if s.name == "decode.loop" and s.start_ns >= t0]
    return out, loops, calls[0]


def assert_same(a: dict, b: dict) -> None:
    """Two ``make_decode_fn`` results equal bit for bit."""
    assert (a["n_frames"], a["n_steps"]) == (b["n_frames"], b["n_steps"])
    for k in RESULT_KEYS:
        assert torch.equal(a[k], b[k]), k


def assert_rolled_back(out: dict, rows: slice, kept: int, r: int) -> None:
    """Rows ``rows`` of a result hold zero frames and ``NEG_INF`` stop
    logits from position ``kept`` on."""
    assert not out["pred_melspec"][rows, kept * r:].any()
    assert bool((out["pred_stop"][rows, kept * r:] == NEG_INF).all())
