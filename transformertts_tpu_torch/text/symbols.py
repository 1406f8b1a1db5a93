"""Phoneme symbol table.

Reproduces the reference's symbol inventory exactly (ref: preprocess.py:21-25):
``symbols = g2p.phonemes + list("!'(),.:;? ")`` where ``g2p.phonemes`` is the
g2p_en ARPAbet list — 4 specials, then the CMUdict phone set with stress
markers on vowels (g2p_en also carries a stress-less ``UW`` entry, which we
keep for index compatibility).

Sequence encoding drops out-of-vocabulary symbols silently, like the
reference (ref: audio.py:62-63).
"""

from __future__ import annotations

# g2p_en G2p.phonemes — order matters: ids index into this list.
_SPECIALS = ["<pad>", "<unk>", "<s>", "</s>"]

_ARPABET = [
    "AA0", "AA1", "AA2", "AE0", "AE1", "AE2", "AH0", "AH1", "AH2",
    "AO0", "AO1", "AO2", "AW0", "AW1", "AW2", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH",
    "EH0", "EH1", "EH2", "ER0", "ER1", "ER2", "EY0", "EY1", "EY2",
    "F", "G", "HH",
    "IH0", "IH1", "IH2", "IY0", "IY1", "IY2",
    "JH", "K", "L", "M", "N", "NG",
    "OW0", "OW1", "OW2", "OY0", "OY1", "OY2",
    "P", "R", "S", "SH", "T", "TH",
    "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2",
    "V", "W", "Y", "Z", "ZH",
]

PHONEMES: list[str] = _SPECIALS + _ARPABET

PUNCTUATION: list[str] = list("!'(),.:;? ")  # ref: preprocess.py:23

SYMBOLS: list[str] = PHONEMES + PUNCTUATION

_SYMBOL_TO_ID: dict[str, int] = {s: i for i, s in enumerate(SYMBOLS)}

PAD_ID = _SYMBOL_TO_ID["<pad>"]  # 0 — also the batch-padding value
N_SYMBOLS = len(SYMBOLS)


def symbol_to_id(symbol: str) -> int | None:
    return _SYMBOL_TO_ID.get(symbol)


def phoneme_to_sequence(phonemes: list[str]) -> list[int]:
    """Phoneme strings -> ids; OOV dropped silently (ref: audio.py:62-63)."""
    return [_SYMBOL_TO_ID[p] for p in phonemes if p in _SYMBOL_TO_ID]


def sequence_to_phoneme(sequence: list[int]) -> list[str]:
    """Ids -> phoneme strings; out-of-range dropped (ref: audio.py:66-67)."""
    return [SYMBOLS[s] for s in sequence if 0 <= s < N_SYMBOLS]
