"""Number-to-words expansion for text normalization (host-side, pure Python).

The reference delegates this to g2p_en's internal normalizer; this is our own
implementation used by the built-in G2P fallback when g2p_en is unavailable.
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand")]


def int_to_words(n: int) -> str:
    if n < 0:
        return "minus " + int_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[rem] if rem else "")
    if n < 1000:
        hundreds, rem = divmod(n, 100)
        out = _ONES[hundreds] + " hundred"
        return out + (" " + int_to_words(rem) if rem else "")
    for scale, name in _SCALES:
        if n >= scale:
            major, rem = divmod(n, scale)
            out = int_to_words(major) + " " + name
            return out + (" " + int_to_words(rem) if rem else "")
    return str(n)  # pragma: no cover — beyond supported range


def _expand_decimal(match: re.Match) -> str:
    whole, frac = match.group(1), match.group(2)
    digits = " ".join(_ONES[int(d)] for d in frac)
    return f"{int_to_words(int(whole))} point {digits}"


def _expand_int(match: re.Match) -> str:
    return int_to_words(int(match.group(0)))


def normalize_numbers(text: str) -> str:
    text = re.sub(r"(\d+),(\d{3})", r"\1\2", text)  # 1,234 -> 1234
    text = re.sub(r"(\d+)\.(\d+)", _expand_decimal, text)
    text = re.sub(r"\d+", _expand_int, text)
    return text
