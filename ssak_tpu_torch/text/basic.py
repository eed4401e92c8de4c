"""Language-independent text operations: the port's own copy of
ssak_tpu.text.basic (the port imports nothing of ssak_tpu).

Language-independent text operations.

Capability parity with reference ssak/utils/text_basic.py
(collapse_whitespace:6, remove_punctuations:21, format_special_characters:28,
remove_special_words:91, transliterate:191).
"""

import re
import unicodedata

_WHITESPACE_RE = re.compile(r"[\s  -​  　]+")

_PUNCT = ",.;:!?¿¡…\"«»“”„‟‹›&(){}[]<>*/#@§%~^|_+=–—-؛؟،"  # incl. Arabic ؛؟،


def collapse_whitespace(text: str) -> str:
    return _WHITESPACE_RE.sub(" ", text).strip()


def remove_punctuations(text: str, strong: bool = False) -> str:
    """Remove punctuation characters. strong also strips apostrophes/hyphens."""
    chars = _PUNCT + ("'’`" if strong else "")
    out = text.translate(str.maketrans({c: " " for c in chars}))
    return collapse_whitespace(out)


_SPECIAL_MAP = {
    # ligatures
    "œ": "oe", "Œ": "Oe", "æ": "ae", "Æ": "Ae", "ﬁ": "fi", "ﬂ": "fl", "ĳ": "ij",
    # quotes / apostrophes
    "’": "'", "‘": "'", "ʼ": "'", "´": "'", "`": "'", "‛": "'", "“": '"', "”": '"', "„": '"',
    # dashes
    "–": "-", "—": "-", "‐": "-", "‑": "-", "−": "-",
    # spaces handled by collapse_whitespace
    "…": "...",
    # unicode homoglyphs / confusables commonly found in scraped text
    "ߎ": "o", "ᵉ": "e", "ᵈ": "d", "ʳ": "r", "ˢ": "s", "ᵗ": "t",
    "­": "", "‍": "", "﻿": "",  # NOT "¬": it must survive to the logged
    # non-latin removal in text/latin.py (reference logs it to file_special)
    "ǝ": "e", "ɑ": "a",
}

# Cyrillic/Greek homoglyphs: only folded for latin-script languages
# (applied by ssak_tpu_torch.text.latin, NOT here — Russian needs them intact)
LATIN_HOMOGLYPHS = {"ο": "o", "а": "a", "е": "e", "о": "o", "р": "p", "с": "c", "х": "x", "у": "y"}

_SPECIAL_RE = re.compile("|".join(re.escape(k) for k in _SPECIAL_MAP))

# reference text_basic.py:26 _non_printable_pattern — C0/C1 controls are
# silently dropped (NOT logged as special chars; the golden special_chars.txt
# only lists characters that reach the final non-latin removal)
_NON_PRINTABLE_RE = re.compile(r"[\x00-\x08\x0B\x0C\x0E-\x1F\x7F-\x9F]")


def format_special_characters(text: str) -> str:
    """Normalize ligatures, curly quotes, dashes, homoglyphs; NFC-compose."""
    text = unicodedata.normalize("NFC", text)
    text = _NON_PRINTABLE_RE.sub("", text)
    text = _SPECIAL_RE.sub(lambda m: _SPECIAL_MAP[m.group(0)], text)
    return collapse_whitespace(text)


_TAG_RE = re.compile(r"<[^<>\s][^<>]*>|\[[^\[\]\s][^\[\]]*\]|\{[^{}\s][^{}]*\}")


def remove_special_words(text: str, glue_apostrophe: bool = True) -> str:
    """Strip annotation tags like <noise>, [laughter], {breath}."""
    text = _TAG_RE.sub(" ", text)
    text = collapse_whitespace(text)
    if glue_apostrophe:
        text = re.sub(r"'\s+", "'", text)
    return text


def transliterate(text: str) -> str:
    """Best-effort latin transliteration (é->e, ü->u, ...)."""
    text = format_special_characters(text)
    out = unicodedata.normalize("NFD", text)
    out = "".join(c for c in out if unicodedata.category(c) != "Mn")
    return unicodedata.normalize("NFC", out)


def _ascii_only(text: str) -> str:
    return transliterate(text).encode("ascii", "ignore").decode("ascii")
