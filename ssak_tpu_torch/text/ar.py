"""Arabic text normalization.

Counterpart of reference ssak/utils/text_ar.py (format_text_ar:143):
diacritics removal, Hindi→Western digit mapping, tatweel removal, alef/teh
normalization, latin/arabic ungluing, arabic-only filtering, and digit
verbalization (Modern Standard Arabic cardinals, masculine form).
"""

import re

from ssak_tpu_torch.text.basic import collapse_whitespace

_DIACRITICS = re.compile(r"[ؐ-ًؚ-ٰٟۖ-ۜ۟-۪ۨ-ۭـ]")

_HINDI_DIGITS = str.maketrans("٠١٢٣٤٥٦٧٨٩۰۱۲۳۴۵۶۷۸۹", "01234567890123456789")

_AR_PUNCT = "؟؛،«»"

_ARABIC_BLOCK = re.compile(r"[؀-ۿݐ-ݿ]")
_LATIN_BLOCK = re.compile(r"[A-Za-z]")


def remove_diacritics(text: str) -> str:
    return _DIACRITICS.sub("", text)


def normalize_alef_teh(text: str) -> str:
    text = re.sub("[إأآا]", "ا", text)
    text = text.replace("ى", "ي").replace("ة", "ه").replace("ؤ", "و").replace("ئ", "ي")
    return text


def unglue_scripts(text: str) -> str:
    """Insert spaces between glued latin/arabic runs."""
    text = re.sub(r"([A-Za-z])([؀-ۿ])", r"\1 \2", text)
    text = re.sub(r"([؀-ۿ])([A-Za-z])", r"\1 \2", text)
    return text


_AR_UNITS = ["صفر", "واحد", "اثنان", "ثلاثة", "أربعة", "خمسة", "ستة", "سبعة", "ثمانية", "تسعة", "عشرة"]
_AR_TEENS = ["عشرة", "أحد عشر", "اثنا عشر", "ثلاثة عشر", "أربعة عشر", "خمسة عشر", "ستة عشر", "سبعة عشر", "ثمانية عشر", "تسعة عشر"]
_AR_TENS = ["", "عشرة", "عشرون", "ثلاثون", "أربعون", "خمسون", "ستون", "سبعون", "ثمانون", "تسعون"]
_AR_HUNDREDS = ["", "مائة", "مائتان", "ثلاثمائة", "أربعمائة", "خمسمائة", "ستمائة", "سبعمائة", "ثمانمائة", "تسعمائة"]


def ar_cardinal(n: int) -> str:
    if n < 0:
        return "سالب " + ar_cardinal(-n)
    if n <= 10:
        return _AR_UNITS[n]
    if n < 20:
        return _AR_TEENS[n - 10]
    if n < 100:
        t, u = divmod(n, 10)
        return _AR_TENS[t] if u == 0 else f"{_AR_UNITS[u]} و{_AR_TENS[t]}"
    if n < 1000:
        h, rest = divmod(n, 100)
        head = _AR_HUNDREDS[h]
        return head if rest == 0 else f"{head} و{ar_cardinal(rest)}"
    for scale, one, two, many in (
        (10**9, "مليار", "ملياران", "مليارات"),
        (10**6, "مليون", "مليونان", "ملايين"),
        (10**3, "ألف", "ألفان", "آلاف"),
    ):
        if n >= scale:
            q, rest = divmod(n, scale)
            if q == 1:
                head = one
            elif q == 2:
                head = two
            elif q <= 10:
                head = f"{ar_cardinal(q)} {many}"
            else:
                head = f"{ar_cardinal(q)} {one}"
            return head if rest == 0 else f"{head} و{ar_cardinal(rest)}"
    raise ValueError(n)


def digits_to_words_ar(text: str) -> str:
    return re.sub(r"\d+", lambda m: ar_cardinal(int(m.group(0))), text)


def format_text_ar(
    text: str,
    keep_latin_chars: bool = True,
    normalize_dialect_words: bool = False,
    bw: bool = False,
    **kwargs,
) -> str:
    """Normalize Arabic text. With bw=True, transliterate to Buckwalter."""
    text = text.translate(_HINDI_DIGITS)
    text = remove_diacritics(text)
    text = unglue_scripts(text)
    for p in _AR_PUNCT + ".,;:!?\"'()[]{}«»…-":
        text = text.replace(p, " ")
    text = digits_to_words_ar(text)
    if not keep_latin_chars:
        text = _LATIN_BLOCK.sub(" ", text)
    text = collapse_whitespace(text)
    if bw:
        text = to_buckwalter(text)
    return text


_BW_MAP = {
    "ء": "'", "آ": "|", "أ": ">", "ؤ": "&", "إ": "<", "ئ": "}", "ا": "A",
    "ب": "b", "ة": "p", "ت": "t", "ث": "v", "ج": "j", "ح": "H", "خ": "x",
    "د": "d", "ذ": "*", "ر": "r", "ز": "z", "س": "s", "ش": "$", "ص": "S",
    "ض": "D", "ط": "T", "ظ": "Z", "ع": "E", "غ": "g", "ف": "f", "ق": "q",
    "ك": "k", "ل": "l", "م": "m", "ن": "n", "ه": "h", "و": "w", "ى": "Y",
    "ي": "y", "ً": "F", "ٌ": "N", "ٍ": "K", "َ": "a", "ُ": "u", "ِ": "i",
    "ّ": "~", "ْ": "o",
}


def to_buckwalter(text: str) -> str:
    """Arabic → Buckwalter transliteration (reference text_ar.py:96)."""
    return "".join(_BW_MAP.get(c, c) for c in text)


_AR_TERMINALS = ",-:!;.؛؟،?_"


def make_text_augmenter(language: str, seed: int = 0):
    """Stochastic label-text augmentation for seq2seq fine-tuning
    (reference whisper_train.py:302-336, Arabic only there too): with
    independent 50% chances, verbalize digits, strip vs keep punctuation
    (adding a terminal dot when kept), so the model sees both written and
    verbalized label styles. Deterministic under `seed`."""
    import random

    from ssak_tpu_torch.text.basic import collapse_whitespace, remove_punctuations

    if language != "ar":
        raise NotImplementedError(f"text augmentation not implemented for language {language!r}")
    rng = random.Random(seed)

    def augment(text: str) -> str:
        if rng.random() < 0.5:
            text = digits_to_words_ar(text)
        if rng.random() < 0.5:
            text = remove_punctuations(text)
        else:
            if text and text[-1] not in _AR_TERMINALS:
                text = text + "."
        return collapse_whitespace(text)

    return augment
