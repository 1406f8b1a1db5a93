"""Context-rule heteronym disambiguation for the fallback g2p.

The reference's frontend (g2p_en, ref audio.py:54-59) disambiguates
heteronyms — words whose pronunciation depends on their grammatical role
("read", "lead", "live", "record", ...) — with a sentence POS tagger.
The built-in fallback has one pronunciation per lexicon entry; this
module recovers the most common contrasts with neighbor-word trigger
rules, no POS model:

- each rule is (prev-word triggers, next-word triggers, phones); the
  FIRST rule whose trigger matches wins;
- no match -> ``None`` and the caller falls through to the lexicon
  entry, so behavior only changes when a trigger fires (golden outputs
  for trigger-free sentences are untouched);
- for heteronyms absent from the lexicon (bass, dove, sow) a default is
  provided here.

Two shared trigger sets approximate POS: ``_V`` (infinitive/modal
context -> verb reading) and ``_N`` (determiner/possessive context ->
noun reading).  Word-specific semantic triggers (e.g. "lead pipe",
"live broadcast") are spelled per word.
"""

from __future__ import annotations

# modal / infinitive context: the next word is (almost always) a verb
_V = frozenset(
    "to will would can could may might shall should must don't doesn't "
    "didn't won't cannot can't please".split()
)
# subject pronouns: transparent for prev-triggers, so "could you elaborate"
# sees the modal two words back (measured miss in tools/heteronym_eval.py)
_PRONOUNS = frozenset("i you we they he she it".split())
# determiner / possessive context: the next word is a noun (or adj+noun)
_N = frozenset(
    "a an the this that these those its his her their our my your of no "
    "any some each every".split()
)

# word -> list of (prev_triggers | None, next_triggers | None, phones);
# first match wins; None = that side never triggers the rule.
_RULES: dict[str, list[tuple[frozenset | None, frozenset | None, list[str]]]] = {
    # ---- vowel-quality contrasts
    # lexicon default: R EH1 D (past — narration register)
    "read": [(_V, None, ["R", "IY1", "D"])],
    # lexicon default: L IY1 D (verb/guide); metal in compounds
    "lead": [
        (frozenset({"molten", "of"}),
         frozenset("pipe pipes poisoning paint pencil pencils shot ore "
                   "oxide weights".split()),
         ["L", "EH1", "D"]),
    ],
    # lexicon default: L IH1 V (verb); adjective before media nouns
    "live": [
        (None,
         frozenset("broadcast broadcasts music audience performance "
                   "performances show shows television coverage stream "
                   "streaming wire wires ammunition animals".split()),
         ["L", "AY1", "V"]),
    ],
    # lexicon default: W IH1 N D (noun); verb in phrasal "wind up/down"
    "wind": [
        (None, frozenset({"up", "down", "through", "around"}),
         ["W", "AY1", "N", "D"]),
    ],
    # lexicon default: B AW1 (bend); weapon/knot before "and arrow"/"tie"
    "bow": [
        (frozenset({"violin", "fiddle"}), frozenset({"and", "tie", "ties"}),
         ["B", "OW1"]),
    ],
    # lexicon default: T EH1 R (rip); eye-tear in weeping contexts
    "tear": [
        (frozenset({"shed", "single"}),
         frozenset({"rolled", "fell", "ran", "drops"}),
         ["T", "IH1", "R"]),
    ],
    # lexicon default: W UW1 N D (injury); past-of-wind in phrasal use
    "wound": [
        (None, frozenset({"up", "down", "around", "through",
                          "tight", "tightly"}),
         ["W", "AW1", "N", "D"]),
    ],
    # lexicon default: M IH1 N AH0 T (time); adjective "tiny" before
    # quantity nouns
    "minute": [
        (None,
         frozenset("amount amounts quantity quantities particle particles "
                   "detail details trace traces fraction difference "
                   "differences".split()),
         ["M", "AY0", "N", "UW1", "T"]),
    ],
    # lexicon default: K L OW1 S (adj); verb before an object
    "close": [
        (_V, frozenset({"the", "a", "an", "it", "them", "his", "her",
                        "their", "your", "down"}),
         ["K", "L", "OW1", "Z"]),
    ],
    # lexicon default: Y UW1 S (noun); verb after modals / before object
    "use": [
        (_V, frozenset({"it", "them", "this", "that", "these", "those",
                        "a", "an", "the", "his", "her", "its", "their",
                        "your", "our"}),
         ["Y", "UW1", "Z"]),
    ],
    # ---- noun/verb stress shifts (lexicon default noted per word)
    # default: noun R EH1 K ER0 D
    "record": [(_V, None, ["R", "IH0", "K", "AO1", "R", "D"])],
    # default: noun/adj P R EH1 Z AH0 N T
    "present": [(_V, None, ["P", "R", "IH0", "Z", "EH1", "N", "T"])],
    # default: verb P R AH0 D UW1 S
    "produce": [
        (_N, None, ["P", "R", "OW1", "D", "UW0", "S"]),
        # grocery adjectives: "fresh/local produce" (noun)
        (frozenset({"fresh", "local", "organic", "farm"}), None,
         ["P", "R", "OW1", "D", "UW0", "S"]),
    ],
    # default: noun P R AA1 JH EH0 K T
    "project": [(_V, None, ["P", "R", "AH0", "JH", "EH1", "K", "T"])],
    # default: noun AA1 B JH EH0 K T
    "object": [(_V, None, ["AH0", "B", "JH", "EH1", "K", "T"])],
    # default: noun S AH1 B JH IH0 K T
    "subject": [(_V, None, ["S", "AH0", "B", "JH", "EH1", "K", "T"])],
    # default: noun K AA1 N T EH0 N T; adjective after copulas
    "content": [
        (frozenset("is are was were been am be seem seems seemed feel "
                   "feels felt quite very so".split()), None,
         ["K", "AH0", "N", "T", "EH1", "N", "T"]),
    ],
    # default: noun D EH1 Z ER0 T
    "desert": [(_V, None, ["D", "IH0", "Z", "ER1", "T"])],
    # default: verb R IH0 F Y UW1 Z; garbage after determiners
    "refuse": [(_N, None, ["R", "EH1", "F", "Y", "UW2", "S"])],
    # default: verb P ER0 M IH1 T
    "permit": [
        (_N, None, ["P", "ER1", "M", "IH0", "T"]),
        # licence compounds: "fishing/parking permit" (noun)
        (frozenset({"fishing", "parking", "work", "building", "travel",
                    "residence", "learner's", "gun"}), None,
         ["P", "ER1", "M", "IH0", "T"]),
    ],
    # default: noun K AA1 N D AH0 K T
    "conduct": [(_V, None, ["K", "AH0", "N", "D", "AH1", "K", "T"])],
    # default: noun K AA1 N T R AE2 K T
    "contract": [(_V, None, ["K", "AH0", "N", "T", "R", "AE1", "K", "T"])],
    # default: verb K AH0 N V ER1 T
    "convert": [(_N, None, ["K", "AA1", "N", "V", "ER0", "T"])],
    # default: verb IH0 N K R IY1 S
    "increase": [(_N, None, ["IH1", "N", "K", "R", "IY2", "S"])],
    # default: verb D IH0 K R IY1 S
    "decrease": [(_N, None, ["D", "IH1", "K", "R", "IY2", "S"])],
    # ---- -ate noun/adj vs verb (default noted per word)
    # default: noun EH1 S T AH0 M AH0 T
    "estimate": [(_V, None, ["EH1", "S", "T", "AH0", "M", "EY2", "T"])],
    # default: adj S EH1 P ER0 IH0 T
    "separate": [(_V, None, ["S", "EH1", "P", "ER0", "EY2", "T"])],
    # default: adj M AA1 D ER0 AH0 T
    "moderate": [(_V, None, ["M", "AA1", "D", "ER0", "EY2", "T"])],
    # default: adj D IH0 L IH1 B ER0 AH0 T
    "deliberate": [(_V, None, ["D", "IH0", "L", "IH1", "B", "ER0", "EY2", "T"])],
    # default: adj IH0 L AE1 B ER0 AH0 T
    "elaborate": [(_V, None, ["IH0", "L", "AE1", "B", "ER0", "EY2", "T"])],
    # default: verb AH0 S OW1 S IY0 EY2 T; noun after determiners
    "associate": [(_N, None, ["AH0", "S", "OW1", "S", "IY0", "AH0", "T"])],
    # default: verb AE1 D V AH0 K EY2 T; noun after determiners
    "advocate": [(_N, None, ["AE1", "D", "V", "AH0", "K", "AH0", "T"])],
    # default: adj AO1 L T ER0 N EY2 T (lexicon keeps EY2 T) — verb same
    # surface; noun/adj AH0 T after determiners
    "alternate": [(_N, None, ["AO1", "L", "T", "ER0", "N", "AH0", "T"])],
}

# heteronyms with no lexicon entry: default used when no rule fires
_DEFAULTS: dict[str, list[str]] = {
    "bass": ["B", "EY1", "S"],       # music register default
    "dove": ["D", "AH1", "V"],       # the bird
    "sow": ["S", "OW1"],             # to plant
    "graduate": ["G", "R", "AE1", "JH", "AH0", "W", "AH0", "T"],
    "duplicate": ["D", "UW1", "P", "L", "AH0", "K", "AH0", "T"],
    "delegate": ["D", "EH1", "L", "AH0", "G", "AH0", "T"],
}
_RULES["bass"] = [
    (frozenset({"striped", "sea", "largemouth", "smallmouth"}),
     frozenset({"fishing", "fish"}), ["B", "AE1", "S"]),
]
_RULES["dove"] = [
    (None, frozenset({"into", "in", "under", "down", "off", "beneath",
                      "toward", "towards", "overboard"}),
     ["D", "OW1", "V"]),
]
_RULES["sow"] = [
    # determiner context: the animal ("the sow nursed her piglets")
    (_N, None, ["S", "AW1"]),
]
_RULES["graduate"] = [(_V, None, ["G", "R", "AE1", "JH", "UW0", "EY2", "T"])]
_RULES["duplicate"] = [(_V, None, ["D", "UW1", "P", "L", "AH0", "K", "EY2", "T"])]
_RULES["delegate"] = [(_V, None, ["D", "EH1", "L", "AH0", "G", "EY2", "T"])]

# ---- sentence-context rules (round 4) -------------------------------
# Three POS-gap patterns the neighbor-trigger rules could not model
# (measured 0/3 on the round-4 golden set; g2p_en resolves them with a
# sentence POS tagger, ref audio.py:54-59):
#
# 1. present-tense "read": a frequency adverb directly before ("i often
#    read"), or a plural/2nd-person subject pronoun plus a habitual
#    adverbial anywhere later in the sentence ("they read books every
#    evening").  Singular he/she + read stays the past default — the
#    narration register's dominant reading.
# 2. adverbial "live" after a performance/broadcast verb ("played
#    live", "went live", "streamed live") -> L AY1 V.
# 3. plural-noun subject + clause/adverb cue after a noun-default
#    noun/verb stress pair ("metals contract when they cool",
#    "pupils contract in bright light") -> the verb reading.  The prev
#    word must look like a plural content noun (ends in -s, not a
#    closed-class word); known false positive: noun compounds whose
#    head follows a plural attributive ("a sales contract when...").
_FREQ_ADV = frozenset(
    "often always usually rarely never sometimes frequently regularly "
    "occasionally seldom daily".split()
)
_HABITUAL = frozenset(
    "every each often always usually daily nightly weekly regularly "
    "frequently".split()
)
_READ_SUBJECTS = frozenset({"i", "you", "we", "they"})
_PERF_VERBS = frozenset(
    "played plays playing performed performs performing went goes going "
    "gone broadcast broadcasting aired airing streamed streaming sang "
    "sung singing appeared appearing recorded".split()
)
_CLAUSE_CUES = frozenset(
    "when as if while because during under rapidly sharply quickly "
    "slowly significantly slightly further again in".split()
)
# closed-class / adverb words ending in -s that are NOT plural nouns
_NOT_PLURAL_NOUNS = frozenset(
    "is was has does as its his hers ours yours theirs this thus always "
    "sometimes perhaps unless across besides".split()
)
# noun-default stress pairs whose verb reading rule #3 can select: the
# verb phones are the ones their _V trigger rule already carries
_SUBJECT_VERB_WORDS = frozenset(
    "record present project object subject conduct contract desert".split()
)


def _plural_content_noun(word: str) -> bool:
    return (
        len(word) > 3
        and word.endswith("s")
        and not word.endswith("ss")
        and "'" not in word  # "nation's contract in ..." is possessive,
        # not a plural subject — keep the noun default
        and word not in _NOT_PLURAL_NOUNS
        and word not in _FREQ_ADV
        and word not in _V
        and word not in _N
        and word not in _PRONOUNS
    )


def _context_phones(
    word: str,
    prev: str | None,
    nxt: str | None,
    sentence: tuple[str, ...] | None,
    idx: int | None,
) -> list[str] | None:
    if word == "read":
        if prev in _FREQ_ADV:
            return ["R", "IY1", "D"]
        if (
            prev in _READ_SUBJECTS
            and sentence is not None
            and idx is not None
            and _HABITUAL.intersection(sentence[idx + 1:])
        ):
            return ["R", "IY1", "D"]
    elif word == "live":
        if prev in _PERF_VERBS:
            return ["L", "AY1", "V"]
    elif word in _SUBJECT_VERB_WORDS:
        if (
            prev is not None
            and nxt in _CLAUSE_CUES
            and _plural_content_noun(prev)
        ):
            return list(_RULES[word][0][2])
    return None


def heteronym_phones(
    word: str,
    prev: str | None,
    nxt: str | None,
    prev2: str | None = None,
    sentence: tuple[str, ...] | None = None,
    idx: int | None = None,
) -> list[str] | None:
    """Phones for ``word`` given its neighboring WORDS (lowercase, no
    punctuation), or None to fall through to the lexicon/LTS path.

    ``prev2`` (two words back) lets a prev-trigger see through a subject
    pronoun: "could you elaborate", "will they record".  ``sentence``
    (all words of the utterance) + ``idx`` (this word's position in it)
    enable the sentence-context rules (habitual "they read ... every
    evening"); without them only the neighbor rules apply."""
    rules = _RULES.get(word)
    if rules is None:
        return None
    if prev in _PRONOUNS and prev2 is not None:
        eff_prev2 = prev2
    else:
        eff_prev2 = None
    for prev_trig, next_trig, phones in rules:
        if prev_trig is not None and (
            (prev is not None and prev in prev_trig)
            or (eff_prev2 is not None and eff_prev2 in prev_trig)
        ):
            return list(phones)
        if next_trig is not None and nxt is not None and nxt in next_trig:
            return list(phones)
    ctx = _context_phones(word, prev, nxt, sentence, idx)
    if ctx is not None:
        return ctx
    return list(_DEFAULTS[word]) if word in _DEFAULTS else None
