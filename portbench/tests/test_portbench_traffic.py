"""The traffic generators: exact repeats for a seed, the stated length
statistics, every bucket reached, and prompts the program reads as the
reference does."""

import numpy as np
import pytest

from portbench import harness, textgen
from portbench.reference.text import sentence_ids
from portbench.traffic import train


def test_sentence_has_exactly_the_asked_ids():
    rng = np.random.default_rng(3)
    for n in list(range(4, 200)) * 2:
        assert len(sentence_ids(textgen.sentence(rng, n))) == n


def test_sentences_repeat_for_a_seed_and_differ_across_seeds():
    lens = textgen.clipped_normal(1501, 50, 95, 25, 30, 190)
    a = textgen.sentences(textgen.run_rng(2**31 + 5, 2), lens)
    b = textgen.sentences(textgen.run_rng(2**31 + 5, 2), lens)
    c = textgen.sentences(textgen.run_rng(2**31 + 6, 2), lens)
    assert a == b and a != c and len(set(a)) == len(a)


@pytest.mark.parametrize("cell", ["ljspeech.serve-poisson", "ljspeech.stream-b1",
                                  "paper.serve-backlog"])
def test_prompt_lengths_match_ljspeech(cell):
    mean, std, lo, hi = harness.cell_spec(cell)["params"]["phonemes"]
    lens = textgen.clipped_normal(harness.cell_spec(cell)["params"]["shape_seed"], 4000,
                                  mean, std, lo, hi)
    assert abs(lens.mean() - 95) < 2 and abs(lens.std() - 25) < 2
    assert lens.min() >= 30 and lens.max() <= 190
    buckets = harness.config_spec("ljspeech")["runtime"]["phoneme_buckets"]
    hit = {next(b for b in buckets if b >= n) for n in lens}
    assert hit == set(buckets)


def test_seed_permutes_a_fixed_multiset():
    lens = textgen.clipped_normal(1501, 300, 95, 25, 30, 190)
    a = textgen.run_rng(11, 1).permutation(lens)
    b = textgen.run_rng(2**31 + 11, 1).permutation(lens)
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)


def test_training_corpus_lengths():
    p = harness.cell_spec("paper.train-buckets")["params"]
    p_lens, m_lens = train.corpus_lengths(p)
    assert len(m_lens) == p["clips"]
    assert abs(m_lens.mean() - 566) < 15 and abs(m_lens.std() - 120) < 15
    assert m_lens.min() >= 95 and m_lens.max() <= 870
    assert abs(p_lens.mean() - 95) < 3 and 18 < p_lens.std() < 30
    a, b = train.corpus_lengths(p)
    assert np.array_equal(a, p_lens) and np.array_equal(b, m_lens)


def test_program_g2p_reads_the_prompts_as_the_reference():
    from transformertts_tpu_torch.text import G2p, phonemize

    g2p = G2p()
    rng = np.random.default_rng(9)
    for n in range(30, 191, 7):
        text = textgen.sentence(rng, n)
        assert phonemize(text, g2p)[1] == sentence_ids(text)
