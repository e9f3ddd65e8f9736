"""Grapheme→phoneme frontend: a copy of ``text/g2p.py`` in the JAX package
(kept here because importing that package imports jax).  ≡ ``vall_e/emb/g2p.py``.

The reference uses the ``g2p_en`` package (NLTK + a small seq2seq for OOV).
This rebuild keeps the same interface and output conventions —
``encode(text) -> list[str]`` of ARPAbet-style phones with spaces and
punctuation mapped to ``"_"`` (``emb/g2p.py:26-28``) — and resolves phones
with a three-tier strategy:

  1. ``g2p_en`` when importable (bit-compatible with the reference);
  2. a built-in lexicon of common English words (ARPAbet);
  3. deterministic letter-to-sound rules for OOV words.

G2P is host-side text preprocessing, not a device workload (SURVEY §2.3);
what the downstream model needs is *determinism and symmap stability*, which
all three tiers guarantee.
"""

from __future__ import annotations

import re
import string
from functools import cache

# A compact ARPAbet lexicon for frequent English words (stress digits kept,
# matching g2p_en's convention).
LEXICON: dict[str, list[str]] = {
    "a": ["AH0"], "about": ["AH0", "B", "AW1", "T"], "after": ["AE1", "F", "T", "ER0"],
    "all": ["AO1", "L"], "also": ["AO1", "L", "S", "OW0"], "am": ["AE1", "M"],
    "an": ["AE1", "N"], "and": ["AH0", "N", "D"], "any": ["EH1", "N", "IY0"],
    "are": ["AA1", "R"], "as": ["AE1", "Z"], "at": ["AE1", "T"],
    "be": ["B", "IY1"], "because": ["B", "IH0", "K", "AO1", "Z"],
    "been": ["B", "IH1", "N"], "but": ["B", "AH1", "T"], "by": ["B", "AY1"],
    "can": ["K", "AE1", "N"], "come": ["K", "AH1", "M"],
    "could": ["K", "UH1", "D"], "day": ["D", "EY1"], "do": ["D", "UW1"],
    "even": ["IY1", "V", "IH0", "N"], "first": ["F", "ER1", "S", "T"],
    "for": ["F", "AO1", "R"], "from": ["F", "R", "AH1", "M"],
    "get": ["G", "EH1", "T"], "give": ["G", "IH1", "V"], "go": ["G", "OW1"],
    "good": ["G", "UH1", "D"], "had": ["HH", "AE1", "D"],
    "has": ["HH", "AE1", "Z"], "have": ["HH", "AE1", "V"], "he": ["HH", "IY1"],
    "her": ["HH", "ER1"], "here": ["HH", "IY1", "R"], "him": ["HH", "IH1", "M"],
    "his": ["HH", "IH1", "Z"], "how": ["HH", "AW1"], "i": ["AY1"],
    "if": ["IH1", "F"], "in": ["IH1", "N"], "into": ["IH1", "N", "T", "UW0"],
    "is": ["IH1", "Z"], "it": ["IH1", "T"], "its": ["IH1", "T", "S"],
    "just": ["JH", "AH1", "S", "T"], "know": ["N", "OW1"],
    "like": ["L", "AY1", "K"], "look": ["L", "UH1", "K"],
    "make": ["M", "EY1", "K"], "man": ["M", "AE1", "N"], "me": ["M", "IY1"],
    "more": ["M", "AO1", "R"], "my": ["M", "AY1"], "new": ["N", "UW1"],
    "no": ["N", "OW1"], "noise": ["N", "OY1", "Z"], "not": ["N", "AA1", "T"],
    "now": ["N", "AW1"], "of": ["AH1", "V"], "on": ["AA1", "N"],
    "one": ["W", "AH1", "N"], "only": ["OW1", "N", "L", "IY0"],
    "or": ["AO1", "R"], "other": ["AH1", "DH", "ER0"], "our": ["AW1", "ER0"],
    "out": ["AW1", "T"], "over": ["OW1", "V", "ER0"],
    "people": ["P", "IY1", "P", "AH0", "L"], "said": ["S", "EH1", "D"],
    "see": ["S", "IY1"], "she": ["SH", "IY1"], "so": ["S", "OW1"],
    "some": ["S", "AH1", "M"], "take": ["T", "EY1", "K"],
    "than": ["DH", "AE1", "N"], "that": ["DH", "AE1", "T"],
    "the": ["DH", "AH0"], "their": ["DH", "EH1", "R"],
    "them": ["DH", "EH1", "M"], "then": ["DH", "EH1", "N"],
    "there": ["DH", "EH1", "R"], "these": ["DH", "IY1", "Z"],
    "they": ["DH", "EY1"], "this": ["DH", "IH1", "S"],
    "time": ["T", "AY1", "M"], "to": ["T", "UW1"], "two": ["T", "UW1"],
    "up": ["AH1", "P"], "us": ["AH1", "S"], "use": ["Y", "UW1", "Z"],
    "very": ["V", "EH1", "R", "IY0"], "was": ["W", "AA1", "Z"],
    "way": ["W", "EY1"], "we": ["W", "IY1"], "well": ["W", "EH1", "L"],
    "were": ["W", "ER1"], "what": ["W", "AH1", "T"], "when": ["W", "EH1", "N"],
    "which": ["W", "IH1", "CH"], "who": ["HH", "UW1"],
    "will": ["W", "IH1", "L"], "with": ["W", "IH1", "DH"],
    "work": ["W", "ER1", "K"], "would": ["W", "UH1", "D"],
    "year": ["Y", "IH1", "R"], "you": ["Y", "UW1"], "your": ["Y", "AO1", "R"],
    "i'm": ["AY1", "M"], "here's": ["HH", "IY1", "R", "Z"],
}

# Ordered letter-to-sound rules for OOV words: (pattern, phones).  Longest
# patterns first; applied left-to-right, deterministic.
_L2S_RULES: list[tuple[str, list[str]]] = [
    ("tion", ["SH", "AH0", "N"]),
    ("sion", ["ZH", "AH0", "N"]),
    ("ough", ["AO1"]),
    ("ight", ["AY1", "T"]),
    ("augh", ["AE1", "F"]),
    ("eigh", ["EY1"]),
    ("tch", ["CH"]),
    ("sch", ["S", "K"]),
    ("dge", ["JH"]),
    ("ing", ["IH0", "NG"]),
    ("ear", ["IH1", "R"]),
    ("our", ["AO1", "R"]),
    ("air", ["EH1", "R"]),
    ("oar", ["AO1", "R"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("gh", ["G"]), ("kn", ["N"]), ("wr", ["R"]), ("mb", ["M"]),
    ("oo", ["UW1"]), ("ee", ["IY1"]), ("ea", ["IY1"]), ("ai", ["EY1"]),
    ("ay", ["EY1"]), ("oa", ["OW1"]), ("ow", ["OW1"]), ("ou", ["AW1"]),
    ("oi", ["OY1"]), ("oy", ["OY1"]), ("au", ["AO1"]), ("aw", ["AO1"]),
    ("ar", ["AA1", "R"]), ("er", ["ER0"]), ("ir", ["ER1"]), ("or", ["AO1", "R"]),
    ("ur", ["ER1"]),
    ("a", ["AE1"]), ("b", ["B"]), ("c", ["K"]), ("d", ["D"]), ("e", ["EH1"]),
    ("f", ["F"]), ("g", ["G"]), ("h", ["HH"]), ("i", ["IH1"]), ("j", ["JH"]),
    ("k", ["K"]), ("l", ["L"]), ("m", ["M"]), ("n", ["N"]), ("o", ["AA1"]),
    ("p", ["P"]), ("q", ["K"]), ("r", ["R"]), ("s", ["S"]), ("t", ["T"]),
    ("u", ["AH1"]), ("v", ["V"]), ("w", ["W"]), ("x", ["K", "S"]),
    ("y", ["IH0"]), ("z", ["Z"]),
]


def letter_to_sound(word: str) -> list[str]:
    """Deterministic rule-based fallback for OOV words."""
    word = word.lower()
    # final magic-e: "make"-style → long vowel (handled approximately by
    # dropping the silent e)
    if len(word) > 3 and word.endswith("e") and word[-2] not in "aeiou":
        word = word[:-1]
    phones: list[str] = []
    i = 0
    while i < len(word):
        for pat, ph in _L2S_RULES:
            if word.startswith(pat, i):
                phones.extend(ph)
                i += len(pat)
                break
        else:
            i += 1  # unknown character: skip
    return phones


@cache
def _g2p_en_model():
    try:
        from g2p_en import G2p

        return G2p()
    except Exception:
        return None


def word_to_phones(word: str) -> list[str]:
    w = word.lower()
    if w in LEXICON:
        return list(LEXICON[w])
    return letter_to_sound(w)


_TOKEN_RE = re.compile(r"[a-zA-Z']+|[0-9]+|\s+|[^\w\s]")

_DIGITS = {
    "0": "zero", "1": "one", "2": "two", "3": "three", "4": "four",
    "5": "five", "6": "six", "7": "seven", "8": "eight", "9": "nine",
}


def encode(graphs: str) -> list[str]:
    """Text → phones; spaces/punctuation → "_" (≡ ``emb/g2p.py:24-28``)."""
    model = _g2p_en_model()
    if model is not None:
        phones = model(graphs)
        ignored = {" ", *string.punctuation}
        return ["_" if p in ignored else p for p in phones]

    out: list[str] = []
    for tok in _TOKEN_RE.findall(graphs):
        if tok.isspace():
            if not out or out[-1] != "_":
                out.append("_")
        elif tok[0].isdigit():
            for j, d in enumerate(tok):
                if j > 0:
                    out.append("_")
                out.extend(word_to_phones(_DIGITS[d]))
        elif tok[0].isalpha() or "'" in tok:
            out.extend(word_to_phones(tok))
        else:
            out.append("_")
    return out
