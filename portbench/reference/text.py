"""Plain text front end of the reference: sentences of the benchmark's own
words to phoneme ids.

The symbol table is g2p_en's (4 specials, the CMUdict ARPAbet set with
stress, a stress-less ``UW``) followed by ``!'(),.:;? ``, the inventory the
original TransformerTTS recipe trains on.  A sentence is words of
``data/words.json`` (CMUdict pronunciations) separated by spaces, with
commas, ending in a full stop; its ids are each token's phonemes or
punctuation mark followed by a word boundary ``' '``, the last boundary
dropped, as g2p_en emits them.
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from pathlib import Path

_SPECIALS = ["<pad>", "<unk>", "<s>", "</s>"]
_ARPABET = (
    "AA0 AA1 AA2 AE0 AE1 AE2 AH0 AH1 AH2 AO0 AO1 AO2 AW0 AW1 AW2 AY0 AY1 AY2 "
    "B CH D DH EH0 EH1 EH2 ER0 ER1 ER2 EY0 EY1 EY2 F G HH IH0 IH1 IH2 IY0 IY1 IY2 "
    "JH K L M N NG OW0 OW1 OW2 OY0 OY1 OY2 P R S SH T TH UH0 UH1 UH2 UW UW0 UW1 UW2 "
    "V W Y Z ZH"
).split()
SYMBOLS = _SPECIALS + _ARPABET + list("!'(),.:;? ")
SYMBOL_ID = {s: i for i, s in enumerate(SYMBOLS)}
WORDS_FILE = Path(__file__).resolve().parent.parent / "data" / "words.json"


@lru_cache(maxsize=1)
def lexicon() -> dict[str, list[str]]:
    """word -> ARPAbet phonemes (CMUdict) of every word the traffic uses."""
    with open(WORDS_FILE, encoding="utf-8") as f:
        return {w: ph.split() for w, ph in json.load(f).items()}


def sentence_ids(text: str) -> list[int]:
    """Phoneme ids of a sentence made of ``lexicon()`` words, ``,`` and ``.``."""
    lex = lexicon()
    out: list[str] = []
    for tok in re.findall(r"[a-z]+|[,.]", text.lower()):
        out.extend([tok] if tok in ",." else lex[tok])
        out.append(" ")
    return [SYMBOL_ID[s] for s in out[:-1]]
