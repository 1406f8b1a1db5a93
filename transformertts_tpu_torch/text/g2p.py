"""Grapheme-to-phoneme frontend.

The reference uses the g2p_en package (ref: preprocess.py:21-25, audio.py:54-59):
CMUdict lookup with a neural fallback, emitting ARPAbet phonemes with word
boundaries as ``' '`` tokens and punctuation as its own tokens.

g2p_en is not guaranteed to be installed, so this module provides:

- ``G2p``: uses g2p_en when importable (bit-exact with the reference), else a
  deterministic built-in fallback — a ~1,450-word CMUdict-convention lexicon
  (text/lexicon.py) + rule-based letter-to-sound — with the same output
  *contract* (ARPAbet tokens, ``' '`` separators, punctuation preserved).
  Coverage on LJSpeech-register text is measured by tools/g2p_coverage.py.
- ``phonemize(transcript, g2p)`` -> (phonemes, sequence) mirroring
  ref audio.py:54-59.

Known limitation — heteronyms: g2p_en disambiguates words like "read" /
"lead" / "live" / "bass" / "wind" by POS-tagging the sentence; the
fallback has ONE pronunciation per lexicon entry (the more frequent form)
and no POS model, so heteronyms resolve to that single form regardless of
context.  Measured rule-LTS phoneme error rate vs hand-graded CMUdict
references is tracked by tools/g2p_per.py (PARITY.md has the number).
"""

from __future__ import annotations

import re

from transformertts_tpu_torch.text.numbers import normalize_numbers
from transformertts_tpu_torch.text.symbols import PUNCTUATION, phoneme_to_sequence

from transformertts_tpu_torch.text.lexicon import LEXICON as _LEXICON

_ABBREVIATIONS = {
    "mr": "mister", "mrs": "missus", "dr": "doctor", "st": "saint",
    "co": "company", "jr": "junior", "etc": "et cetera",
}

# Rule-based letter-to-sound: longest-match digraphs first, then single letters.
_DIGRAPHS: list[tuple[str, list[str]]] = [
    ("tion", ["SH", "AH0", "N"]),
    ("ight", ["AY1", "T"]),
    ("ough", ["AO1"]),
    ("augh", ["AO1"]),
    ("eigh", ["EY1"]),
    ("tch", ["CH"]),
    ("dge", ["JH"]),
    ("sch", ["S", "K"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("wr", ["R"]), ("kn", ["N"]), ("gn", ["N"]), ("mb", ["M"]),
    ("ee", ["IY1"]), ("ea", ["IY1"]), ("oo", ["UW1"]), ("ou", ["AW1"]),
    ("ow", ["OW1"]), ("oy", ["OY1"]), ("oi", ["OY1"]), ("ai", ["EY1"]),
    ("ay", ["EY1"]), ("au", ["AO1"]), ("aw", ["AO1"]), ("ey", ["EY1"]),
    ("ie", ["IY1"]), ("ue", ["UW1"]), ("ui", ["UW1"]), ("oa", ["OW1"]),
    ("ar", ["AA1", "R"]), ("er", ["ER0"]), ("ir", ["ER1"]),
    ("or", ["AO1", "R"]), ("ur", ["ER1"]),
    ("ss", ["S"]), ("ll", ["L"]), ("tt", ["T"]), ("pp", ["P"]),
    ("ff", ["F"]), ("rr", ["R"]), ("nn", ["N"]), ("mm", ["M"]),
    ("dd", ["D"]), ("bb", ["B"]), ("gg", ["G"]), ("zz", ["Z"]),
]

_SINGLE: dict[str, list[str]] = {
    "a": ["AE1"], "b": ["B"], "c": ["K"], "d": ["D"], "e": ["EH1"],
    "f": ["F"], "g": ["G"], "h": ["HH"], "i": ["IH1"], "j": ["JH"],
    "k": ["K"], "l": ["L"], "m": ["M"], "n": ["N"], "o": ["AA1"],
    "p": ["P"], "q": ["K"], "r": ["R"], "s": ["S"], "t": ["T"],
    "u": ["AH1"], "v": ["V"], "w": ["W"], "x": ["K", "S"], "y": ["Y"],
    "z": ["Z"],
}

_VOWEL_PHONES = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
                 "IH", "IY", "OW", "OY", "UH", "UW"}

_WORD_RE = re.compile(r"[a-z']+|[!'(),.:;?]")


_VOICELESS_END = {"P", "T", "K", "F", "TH", "S", "SH", "CH"}
_SIBILANT_END = {"S", "Z", "SH", "ZH", "CH", "JH"}


def _suffix_phones(word: str) -> tuple[str, list[str]] | None:
    """Peel a common inflectional suffix; returns (stem, suffix_phones)."""
    if len(word) > 4 and word.endswith("ly"):
        return word[:-2], ["L", "IY0"]
    if len(word) > 5 and word.endswith("ness"):
        return word[:-4], ["N", "AH0", "S"]
    if len(word) > 5 and word.endswith("ment"):
        return word[:-4], ["M", "AH0", "N", "T"]
    return None


# Derivational suffixes peeled ONLY over a lexicon stem (directly,
# e-restored, or un-doubled) — concatenative in CMUdict convention, no
# stress shift: hope-ful, care-less, wash-able, art-ist, real-ism, dust-y.
_DERIVATIONAL: list[tuple[str, list[str]]] = [
    ("ful", ["F", "AH0", "L"]),
    ("less", ["L", "AH0", "S"]),
    ("able", ["AH0", "B", "AH0", "L"]),
    ("ible", ["AH0", "B", "AH0", "L"]),
    ("ism", ["IH2", "Z", "AH0", "M"]),
    ("ist", ["AH0", "S", "T"]),
    ("ish", ["IH0", "SH"]),
    ("y", ["IY0"]),
]


def _lexicon_stem(base: str) -> list[str] | None:
    """Lexicon phones for a candidate stem: bare, e-restored ("advis-" ->
    "advise"), or un-doubled ("sunn-" -> "sun")."""
    for cand in (base, base + "e",
                 base[:-1] if len(base) > 2 and base[-1] == base[-2] else None):
        if cand and cand in _LEXICON:
            return list(_LEXICON[cand])
    return None


def _demote_primary(phones: list[str]) -> list[str]:
    """Demote primary stress to secondary (for suffixes that take primary)."""
    return [p[:-1] + "2" if p.endswith("1") else p for p in phones]


def _ation_phones(word: str) -> list[str] | None:
    """-ation/-ization nominalizations over lexicon stems.

    "form" + ation -> stem phones (primary demoted) + EY1 SH AH0 N;
    "celebrate" -> final EY2/EY1 T becomes EY1 SH AH0 N;
    "organize" -> final AY2 Z becomes AH0 Z EY1 SH AH0 N.
    Stress demotion approximates CMUdict (which often reduces the stem
    vowel fully, e.g. F AO0 R M EY1 SH AH0 N); phone string is exact for
    the regular classes, stress level may differ by one."""
    if len(word) > 6 and word.endswith("ization"):
        stem = _LEXICON.get(word[:-7] + "ize")
        if stem and stem[-1] == "Z" and stem[-2].startswith("AY"):
            return (_demote_primary(list(stem[:-2]))
                    + ["AH0", "Z", "EY1", "SH", "AH0", "N"])
    if len(word) > 5 and word.endswith("ation"):
        # verb stem + -ation ("form", "transport", "confirm")
        stem = _LEXICON.get(word[:-5])
        if stem:
            return _demote_primary(list(stem)) + ["EY1", "SH", "AH0", "N"]
        # -ate verb ("celebrate" -> "celebration")
        stem = _LEXICON.get(word[:-3] + "e")
        if (stem and len(stem) >= 2 and stem[-1] == "T"
                and stem[-2].startswith("EY")):
            return (_demote_primary(list(stem[:-2]))
                    + ["EY1", "SH", "AH0", "N"])
    return None


def _er_est_stem(word: str, n: int) -> str | None:
    """Lexicon stem for a comparative/superlative: bare ("tight-er"),
    e-restored ("larg-er" -> "large"), un-doubled ("bigg-er" -> "big"),
    y-restored ("earli-er" -> "early")."""
    base = word[:-n]
    for cand in (base, base + "e",
                 base[:-1] if len(base) > 2 and base[-1] == base[-2] else None,
                 base[:-1] + "y" if base.endswith("i") else None):
        if cand and cand in _LEXICON:
            return cand
    return None


def rule_letter_to_sound(word: str) -> list[str]:
    """Deterministic rule-based LTS for out-of-lexicon words."""
    word = word.replace("'", "")

    # inflectional suffixes with phonologically conditioned allomorphs
    def stem_phones(stem: str) -> list[str]:
        return list(_LEXICON.get(stem) or rule_letter_to_sound(stem))

    if len(word) > 4 and word.endswith("ies"):
        # plural/3sg of a -y word: "communities" -> "community" + IY0 Z,
        # but "applies" -> "apply" (ends AY1) + just Z
        stem = _LEXICON.get(word[:-3] + "y")
        if stem:
            stem = list(stem)
            last = stem[-1].rstrip("012") if stem else ""
            if stem and stem[-1] == "IY0":
                return stem[:-1] + ["IY0", "Z"]
            if last in _VOWEL_PHONES:
                return stem + ["Z"]
            # consonant-final -y stem pronunciation: unusual; fall through
            # to the generic -s rule below
    if len(word) > 4 and word.endswith("es") and word[-3] in "sxzh":
        return stem_phones(word[:-2]) + ["IH0", "Z"]
    if len(word) > 3 and word.endswith("s") and not word.endswith("ss"):
        stem = stem_phones(word[:-1])
        if stem:
            last = stem[-1].rstrip("012")
            if last in _SIBILANT_END:
                return stem + ["IH0", "Z"]
            return stem + (["S"] if last in _VOICELESS_END else ["Z"])
    if len(word) > 4 and word.endswith("ed"):
        # lexicon-stem candidates first: bare stem ("print-ed") and
        # e-restored stem ("compos-ed" -> "compose"); for LTS stems only
        # peel when a consonant precedes "ed" so root words like "speed"
        # or "indeed" go through whole-word LTS instead
        stem = _LEXICON.get(word[:-2]) or _LEXICON.get(word[:-2] + "e")
        if stem is None and word[-3] not in "aeiou":
            stem = rule_letter_to_sound(word[:-2])
        if stem:
            stem = list(stem)
            last = stem[-1].rstrip("012")
            if last in {"T", "D"}:
                return stem + ["IH0", "D"]
            return stem + (["T"] if last in _VOICELESS_END else ["D"])
    if len(word) > 4 and word.endswith("ing"):
        # candidates: lexicon stem, e-restored ("making"->"make"),
        # un-doubled ("stopping"->"stop"); LTS peel only for longer words
        # whose bare stem still carries a vowel letter (avoids "str-ing";
        # 5-letter peels like "aging"->"age" are lexicon-stem only)
        stem = (_LEXICON.get(word[:-3]) or _LEXICON.get(word[:-3] + "e")
                or (_LEXICON.get(word[:-4])
                    if len(word) > 5 and word[-4] == word[-5] else None))
        if (stem is None and len(word) > 5
                and any(c in "aeiouy" for c in word[:-3])):
            stem = rule_letter_to_sound(word[:-3])
        if stem:
            return list(stem) + ["IH0", "NG"]
    if len(word) > 4 and (word.endswith("er") or word.endswith("est")):
        # comparative/superlative over a lexicon stem ("tighter", "largest")
        n = 2 if word.endswith("er") else 3
        cand = _er_est_stem(word, n)
        if cand:
            suf = ["ER0"] if n == 2 else ["AH0", "S", "T"]
            return list(_LEXICON[cand]) + suf
    ation = _ation_phones(word)
    if ation is not None:
        return ation
    for suf, sufph in _DERIVATIONAL:
        # lexicon-stem-only derivational peel; stems must be >= 3 letters
        if len(word) > len(suf) + 2 and word.endswith(suf):
            stem = _lexicon_stem(word[: -len(suf)])
            if stem:
                return stem + sufph
    peeled = _suffix_phones(word)
    if peeled is not None:
        stem, suf = peeled
        out = stem_phones(stem)
        if out and out[-1] == suf[0]:
            out = out[:-1]  # "careful" + "ly" -> single L
        return out + suf
    # silent final e after consonant+vowel+consonant ("make", "time")
    if len(word) > 3 and word.endswith("e") and word[-2] not in "aeiou":
        word = word[:-1]
    phones: list[str] = []
    i = 0
    while i < len(word):
        matched = False
        for pattern, ph in _DIGRAPHS:
            if word.startswith(pattern, i):
                phones.extend(ph)
                i += len(pattern)
                matched = True
                break
        if not matched:
            ch = word[i]
            if ch in _SINGLE:
                # soft c/g before front vowels
                if ch == "c" and i + 1 < len(word) and word[i + 1] in "eiy":
                    phones.append("S")
                elif ch == "g" and i + 1 < len(word) and word[i + 1] in "eiy":
                    phones.append("JH")
                elif ch == "y" and i == len(word) - 1 and len(word) > 1:
                    phones.append("IY0")
                else:
                    phones.extend(_SINGLE[ch])
            i += 1
    # guarantee at least one vowel so the word is speakable
    if phones and not any(p.rstrip("012") in _VOWEL_PHONES for p in phones):
        phones.append("AH0")
    return phones


def _normalize_text(text: str) -> str:
    text = text.lower()
    text = normalize_numbers(text)
    for abbr, expansion in _ABBREVIATIONS.items():
        text = re.sub(rf"\b{abbr}\.", expansion, text)
    text = re.sub(r"[\"“”‘’-]", " ", text)
    return text


class _FallbackG2p:
    """Built-in lexicon + rules G2P, used when g2p_en is unavailable."""

    def __call__(self, text: str) -> list[str]:
        from transformertts_tpu_torch.text.heteronyms import heteronym_phones

        # g2p_en contract: ``' '`` after every token (words AND punctuation),
        # trailing separator stripped.
        tokens = _WORD_RE.findall(_normalize_text(text))
        # word-level context for heteronym rules: neighboring WORDS only
        # (punctuation skipped), lowercase, possessive quotes stripped —
        # and bounded to the CURRENT sentence: a habitual adverb in a later
        # sentence must not flip this sentence's "read" to present tense
        sent_end = {".", "!", "?", ";"}
        sentences: list[list[str]] = [[]]
        for t in tokens:
            if t in PUNCTUATION:
                if t in sent_end and sentences[-1]:
                    sentences.append([])
            elif (w := t.strip("'")):
                sentences[-1].append(w)
        sent_tuples = [tuple(s) for s in sentences]
        si, widx = 0, 0  # sentence index, word index within it
        out: list[str] = []
        for tok in tokens:
            if tok in PUNCTUATION:
                out.append(tok)
                if tok in sent_end and widx:
                    si, widx = si + 1, 0
            else:
                word = tok.strip("'")
                if not word:
                    continue
                sent = sent_tuples[si]
                prev = sent[widx - 1] if widx > 0 else None
                prev2 = sent[widx - 2] if widx > 1 else None
                nxt = sent[widx + 1] if widx + 1 < len(sent) else None
                wi = widx
                widx += 1
                phones = heteronym_phones(
                    word, prev, nxt, prev2, sentence=sent, idx=wi)
                out.extend(
                    phones or _LEXICON.get(word) or rule_letter_to_sound(word)
                )
            out.append(" ")
        return out[:-1] if out else out


class G2p:
    """g2p_en-compatible front end; falls back to built-in rules."""

    def __init__(self, backend: str = "auto"):
        self._impl = None
        self.backend = "fallback"
        if backend in ("auto", "g2p_en"):
            try:
                from g2p_en import G2p as _ExtG2p  # type: ignore

                self._impl = _ExtG2p()
                self.backend = "g2p_en"
            except Exception:
                if backend == "g2p_en":
                    raise
        if self._impl is None:
            self._impl = _FallbackG2p()

    def __call__(self, text: str) -> list[str]:
        return self._impl(text)


def phonemize(transcript: str, g2p: G2p) -> tuple[list[str], list[int]]:
    """Transcript -> (phoneme tokens, id sequence). Ref: audio.py:54-59."""
    phonemes = g2p(transcript)
    sequence = phoneme_to_sequence(phonemes)
    return phonemes, sequence
