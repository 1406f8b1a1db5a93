"""Seeded English sentences of a given phoneme length, and the seeded
multisets of sizes and gaps that every traffic kind draws from.

Sizes and gaps come from the cell's fixed ``shape_seed``; the run's
``--seed`` only permutes them and picks the words.  So every seed offers
the same work in another order, and two seeds differ no more than two runs
of one seed.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.text import lexicon, sentence_ids


def clipped_normal(shape_seed: int, n: int, mean: float, std: float, lo: int, hi: int
                   ) -> np.ndarray:
    """n integers ~ N(mean, std) rounded and clipped to [lo, hi]."""
    rng = np.random.default_rng(shape_seed)
    return np.clip(np.rint(rng.normal(mean, std, n)), lo, hi).astype(np.int64)


def run_rng(seed: int, salt: int) -> np.random.Generator:
    """The run's generator for one purpose (``salt``), from ``--seed``."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, salt])


def sentence(rng: np.random.Generator, n_ids: int) -> str:
    """A sentence of lexicon words whose phoneme ids number exactly
    ``n_ids`` (at least 4): words, a comma now and then, a full stop."""
    lex = lexicon()
    by_len: dict[int, list[str]] = {}
    for w, ph in lex.items():
        by_len.setdefault(len(ph), []).append(w)
    lens = sorted(by_len)
    words: list[str] = []
    used = 1  # the full stop
    while True:
        rest = n_ids - used  # ids still to fill: each word takes len + 1
        if rest - 1 in by_len:
            if rest - 1 <= lens[-1] and (rest - 1 <= 6 or rng.random() < 0.3):
                words.append(str(rng.choice(by_len[rest - 1])))
                break
        if words and rest >= 5 and rng.random() < 0.08:
            words[-1] += ","
            used += 2
            continue
        n = int(rng.choice([k for k in lens if k + 1 <= rest - 3] or [lens[0]]))
        words.append(str(rng.choice(by_len[n])))
        used += n + 1
    text = " ".join(words) + "."
    text = text[0].upper() + text[1:]
    if len(sentence_ids(text)) != n_ids:
        raise AssertionError(f"sentence of {len(sentence_ids(text))} ids, wanted {n_ids}")
    return text


def sentences(rng: np.random.Generator, n_ids) -> list[str]:
    """One distinct sentence per length of ``n_ids``."""
    out, seen = [], set()
    for n in n_ids:
        text = sentence(rng, int(n))
        while text in seen:
            text = sentence(rng, int(n))
        seen.add(text)
        out.append(text)
    return out
