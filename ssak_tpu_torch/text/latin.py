"""Latin-script (French/English) text normalization for ASR: the port's
own copy of ssak_tpu.text.latin.

Latin-script (French/English) text normalization for ASR.

From-scratch counterpart of reference ssak/utils/text_latin.py
(format_text_latin:41) + the num2words machinery of text_utils.py, targeting
the same observable behavior (verified against the reference's golden corpus
tests/expected/format_text/output.txt):

  * lowercase, punctuation removal, whitespace collapse
  * parenthesized groups are split out as separate segments
  * URLs spelled out ("http deux points slash slash … point be slash")
  * dates 9/02/2008 -> "neuf février deux mille huit"; dotted dates keep
    "point"; leading-zero numbers read digit-wise ("01" -> "zéro un")
  * times 20h30 -> "vingt heures trente"
  * units (mg, µg, kg, cm, %, €, …) -> words; "%"-> "pour cent"
  * dotted acronyms "U.I." -> "u point i point"; letter-digit "B2" -> "b deux"
  * phone numbers in 2-digit groups; spaced thousands "707 790" joined
  * cardinals/ordinals/decimals/roman numerals via ssak_tpu_torch.text.numbers
"""

import re

from ssak_tpu_torch.text.basic import collapse_whitespace, format_special_characters, remove_special_words
from ssak_tpu_torch.text.numbers import cardinal, decimal_to_words, ordinal, roman_to_decimal
from ssak_tpu_torch.utils.monitoring import logger

# --- language tables ------------------------------------------------------

_FR_MONTHS = {1: "janvier", 2: "février", 3: "mars", 4: "avril", 5: "mai", 6: "juin", 7: "juillet", 8: "août", 9: "septembre", 10: "octobre", 11: "novembre", 12: "décembre"}
_EN_MONTHS = {1: "january", 2: "february", 3: "march", 4: "april", 5: "may", 6: "june", 7: "july", 8: "august", 9: "september", 10: "october", 11: "november", 12: "december"}

_FR_UNITS = {
    "%": "pour cent", "€": "euros", "$": "dollars", "£": "livres", "¥": "yens",
    "µg": "micro grammes", "mg": "milligrammes", "kg": "kilogrammes", "g": "grammes",
    "km": "kilomètres", "cm": "centimètres", "mm": "millimètres", "m": "mètres",
    "km²": "kilomètres carrés", "m²": "mètres carrés", "cm²": "centimètres carrés",
    "km/h": "kilomètres heure", "ghz": "gigahertz", "mhz": "mégahertz", "khz": "kilohertz", "hz": "hertz",
    "go": "giga octets", "mo": "méga octets", "ko": "kilo octets",
    "ml": "millilitres", "cl": "centilitres", "dl": "décilitres", "l": "litres",
    "°c": "degrés celsius", "°": "degrés", "min": "minutes", "sec": "secondes",
}
_EN_UNITS = {
    "%": "percent", "€": "euros", "$": "dollars", "£": "pounds", "¥": "yens",
    "µg": "micrograms", "mg": "milligrams", "kg": "kilograms", "g": "grams",
    "km": "kilometers", "cm": "centimeters", "mm": "millimeters", "m": "meters",
    "ghz": "gigahertz", "mhz": "megahertz", "hz": "hertz",
    "ml": "milliliters", "l": "liters", "°c": "degrees celsius", "°": "degrees",
    "min": "minutes", "sec": "seconds",
}

# case-sensitive: "Me"/"me" (pronoun), "st" etc. must NOT be expanded
_FR_ABBREV = {
    "M.": "monsieur", "MM.": "messieurs", "Mme": "madame", "Mmes": "mesdames",
    "Mlle": "mademoiselle", "Dr": "docteur", "Pr": "professeur",
    "St": "saint", "Ste": "sainte", "bd": "boulevard", "Av.": "avenue",
    "etc.": "et cetera", "etc": "et cetera", "n°": "numéro", "N°": "numéro",
    "vs": "versus",
}
_EN_ABBREV = {
    "Mr": "mister", "Mr.": "mister", "Mrs": "missus", "Mrs.": "missus",
    "Dr": "doctor", "Dr.": "doctor", "St.": "saint",
    "etc.": "et cetera", "etc": "et cetera", "vs": "versus", "vs.": "versus",
    "No.": "number",
}

_URL_CHARS = {
    "fr": {".": "point", "/": "slash", ":": "deux points", "-": "tiret", "_": "tiret bas", "@": "arobase", "#": "dièse", "?": "point d'interrogation", "=": "égal", "&": "et"},
    "en": {".": "dot", "/": "slash", ":": "colon", "-": "dash", "_": "underscore", "@": "at", "#": "hash", "?": "question mark", "=": "equals", "&": "and"},
}


def _lang(language: str) -> str:
    return language.split("-")[0].lower()


def _num(n, language):
    return cardinal(int(n), language)


def _digitwise(s: str, language: str) -> str:
    """Read a number with a leading zero digit-group-wise: '01' -> 'zéro un'."""
    if len(s) >= 2 and s[0] == "0":
        return " ".join(_num(d, language) for d in s)
    return _num(s, language)


# --- individual passes ----------------------------------------------------

_PAREN_RE = re.compile(r"\(([^()]*)\)|\[([^\[\]]*)\]")


def extract_parentheses(text: str):
    """Remove (…) / […] groups; return (main_text, [group, ...])."""
    groups = []

    def _grab(m):
        g = m.group(1) if m.group(1) is not None else m.group(2)
        if g and g.strip():
            groups.append(g.strip())
        return " "

    prev = None
    while prev != text:
        prev = text
        text = _PAREN_RE.sub(_grab, text)
    return text, groups


_URL_RE = re.compile(r"(?:https?://|www\.)[^\s<>«»\"']+", re.IGNORECASE)
_EMAIL_RE = re.compile(r"\b[\w.+-]+@[\w-]+(?:\.[\w-]+)+\b")


def verbalize_url(url: str, language: str) -> str:
    table = _URL_CHARS.get(_lang(language), _URL_CHARS["en"])
    out = []
    for ch in url.lower():
        if ch in table:
            out.append(table[ch])
        else:
            out.append(ch)
    # join runs of plain characters
    text = ""
    for tok in out:
        if len(tok) == 1 and tok.isalnum():
            text += tok
        else:
            text += " " + tok + " "
    return collapse_whitespace(text)


_DATE_SLASH_RE = re.compile(r"\b(\d{1,2})/(\d{1,2})/(\d{2,4})\b")
_TIME_RE = re.compile(r"\b(\d{1,2})\s?h\s?(\d{1,2})?\b", re.IGNORECASE)


def verbalize_dates(text: str, language: str) -> str:
    months = _FR_MONTHS if _lang(language) == "fr" else _EN_MONTHS

    def _sub(m):
        d, mo, y = int(m.group(1)), int(m.group(2)), int(m.group(3))
        if not (1 <= mo <= 12):
            return m.group(0)
        day = "premier" if (d == 1 and _lang(language) == "fr") else _num(d, language)
        return f"{day} {months[mo]} {_num(y, language)}"

    return _DATE_SLASH_RE.sub(_sub, text)


def verbalize_times(text: str, language: str) -> str:
    fr = _lang(language) == "fr"

    def _sub(m):
        h, mins = int(m.group(1)), m.group(2)
        if fr:
            out = f"{_num(h, language)} heure{'s' if h > 1 or h == 0 else ''}"
            if mins and int(mins):
                out += f" {_num(int(mins), language)}"
        else:
            out = f"{_num(h, language)}"
            if mins and int(mins):
                out += f" {_num(int(mins), language)}"
            out += " o'clock" if not (mins and int(mins)) else ""
        return out

    return _TIME_RE.sub(_sub, text)


_ACRONYM_DOTS_RE = re.compile(r"\b(?:[A-Za-zÀ-ÿ]\.){2,}")


def verbalize_dotted_acronyms(text: str, language: str) -> str:
    point = "point" if _lang(language) == "fr" else "dot"

    def _sub(m):
        letters = [c for c in m.group(0) if c != "."]
        return " ".join(f"{c} {point}" for c in letters) + " "

    return _ACRONYM_DOTS_RE.sub(_sub, text)


_ORDINAL_RE = re.compile(r"\b(\d+)(er|ère|ere|ème|eme|e|nd|rd|st|th)\b", re.IGNORECASE)


def verbalize_ordinals(text: str, language: str) -> str:
    fr = _lang(language) == "fr"

    def _sub(m):
        n, suf = int(m.group(1)), m.group(2).lower()
        if fr and suf in ("er", "ère", "ere", "ème", "eme", "e"):
            o = ordinal(n, language)
            if suf in ("ère", "ere"):
                o = "première" if n == 1 else o
            return o
        if not fr and suf in ("st", "nd", "rd", "th"):
            return ordinal(n, language)
        return m.group(0)

    return _ORDINAL_RE.sub(_sub, text)


# single-letter romans restricted to X/V/I to avoid words like "Le", "Ce"
_ROMAN_ORD_RE = re.compile(r"\b([IVXLCDM]{2,7}|[XVI])(er|ère|ème|eme|e)\b")
_ROMAN_CTX_RE = re.compile(r"\b(siècle|chapitre|acte|tome|livre|partie)\b", re.IGNORECASE)


def verbalize_roman(text: str, language: str) -> str:
    """Roman ordinals (XIXème -> dix-neuvième); bare romans before/after
    century-ish context words."""

    def _sub(m):
        v = roman_to_decimal(m.group(1))
        if v is None:
            return m.group(0)
        return ordinal(v, language) if v != 1 else ("premier" if _lang(language) == "fr" else "first")

    return _ROMAN_ORD_RE.sub(_sub, text)


def _unit_pattern(units: dict):
    keys = sorted(units, key=len, reverse=True)
    return re.compile(
        r"(\d+(?:[.,]\d+)?)\s*(" + "|".join(re.escape(k) for k in keys) + r")(?![a-zA-Z²])",
        re.IGNORECASE,
    )


_FR_UNIT_RE = _unit_pattern(_FR_UNITS)
_EN_UNIT_RE = _unit_pattern(_EN_UNITS)


def verbalize_units(text: str, language: str) -> str:
    fr = _lang(language) == "fr"
    units, rx = (_FR_UNITS, _FR_UNIT_RE) if fr else (_EN_UNITS, _EN_UNIT_RE)

    def _sub(m):
        return m.group(1) + " " + units[m.group(2).lower()] + " "

    text = rx.sub(_sub, text)
    # bare symbols without preceding number
    for sym in ("%", "€", "$", "£"):
        text = text.replace(sym, " " + units[sym] + " ")
    return text


_PHONE_RE = re.compile(r"\b(\d{2})([ .])(\d{2})\2(\d{2})\2(\d{2})(?:\2(\d{2}))?\b")


def verbalize_phones(text: str, language: str) -> str:
    def _sub(m):
        groups = [g for g in (m.group(1), m.group(3), m.group(4), m.group(5), m.group(6)) if g]
        return " ".join(_digitwise(g, language) if g[0] == "0" else _num(g, language) for g in groups)

    return _PHONE_RE.sub(_sub, text)


_SPACED_THOUSANDS_RE = re.compile(r"\b(\d{1,3})((?: \d{3})+)\b")
_DECIMAL_RE = re.compile(r"\b(\d+)([.,])(\d+)\b")
_LETTER_DIGIT_RE = re.compile(r"\b([A-Za-zÀ-ÿ]{1,3})(\d{1,4})\b")
_NUMBER_RE = re.compile(r"\d+")


def verbalize_numbers(text: str, language: str) -> str:
    fr = _lang(language) == "fr"
    # join spaced thousands
    text = _SPACED_THOUSANDS_RE.sub(lambda m: m.group(1) + m.group(2).replace(" ", ""), text)

    # decimals: ',' always decimal; '.' reads as point/dot (French corpora)
    def _dec(m):
        ip, sep, fp = m.group(1), m.group(2), m.group(3)
        if sep == ",":
            return decimal_to_words(f"{ip}.{fp}", language)
        word = "point" if fr else "point"
        # 31.12.2003-style chains are handled digit-group-wise by this same
        # rule applied left to right
        frac = _digitwise(fp, language) if fp.startswith("0") else _num(fp, language)
        if set(fp) == {"0"}:
            frac = " ".join(_num(0, language) for _ in fp)
        return f"{_digitwise(ip, language) if ip.startswith('0') and len(ip) > 1 else _num(ip, language)} {word} {frac}"

    prev = None
    while prev != text:
        prev = text
        text = _DECIMAL_RE.sub(_dec, text, count=1)

    # letter-digit splits: B2 -> B deux (skip valid short words)
    text = _LETTER_DIGIT_RE.sub(lambda m: m.group(1) + " " + _num(m.group(2), language), text)

    # remaining integers
    def _int(m):
        s = m.group(0)
        if len(s) > 1 and s[0] == "0":
            return " ".join(_num(d, language) for d in s)
        try:
            return _num(s, language)
        except Exception:
            return " ".join(_num(d, language) for d in s)

    return _NUMBER_RE.sub(_int, text)


def apply_abbreviations(text: str, language: str) -> str:
    table = _FR_ABBREV if _lang(language) == "fr" else _EN_ABBREV
    toks = re.split(r"(\s+)", text)
    return "".join(table.get(t, t) for t in toks)


# early, unlogged removals: symbols that would confuse mid-pipeline passes.
# ® © ™ ¬ ¤ ¦ § ¶ are NOT here — they must reach the final non-latin removal
# so they get logged to fid_special_chars (reference golden special_chars.txt)
_REMOVE_CHARS_RE = re.compile(r"[*†‡]")
# reference remove_punctuations (text_basic.py:15-24): string.punctuation
# minus -' plus typographic extras — notably includes "/" (win 98 / me -> win
# 98 me) so slashes never reach the logged non-latin removal
import string as _string

_PUNCT_STRIP_RE = re.compile(
    "[" + re.escape("".join(c for c in _string.punctuation if c not in "-'") + "¿¡…«»“”„‟‹›•–‘″°、。，！？：؟،؛¨") + "]"
)
_DOT_BETWEEN_RE = re.compile(r"(?<=[a-zà-ÿ])\.(?=[a-zà-ÿ])")

# reference text_utils.py:328 — final removal of anything non-latin, with
# optional logging of removed characters ("%06d char" lines, globally deduped)
_NON_LATIN_RE = re.compile(r"[^a-zA-Z0-9À-ÿ\-'.?!,;: ]")
_ALL_ACRONYMS: list = []
_ALL_SPECIAL_CHARACTERS: list = []


def reset_mined_state() -> None:
    """Clear the global acronym/special-char dedup state (for tests/CLI)."""
    _ALL_ACRONYMS.clear()
    _ALL_SPECIAL_CHARACTERS.clear()


def _remove_non_latin(text: str, fid=None) -> str:
    out = _NON_LATIN_RE.sub("", text)
    if fid is not None:
        for c in text:
            if c not in out and c not in _ALL_SPECIAL_CHARACTERS:
                print(f"{ord(c):06d} {c}", file=fid)
                fid.flush()
                _ALL_SPECIAL_CHARACTERS.append(c)
    return out


def format_text_latin(
    text: str,
    language: str = "fr",
    lower_case: bool = True,
    keep_punc: bool = False,
    extract_parenthesized: bool = True,
    safety_checks: bool = True,
    convert_numbers: bool = True,
    fid_acronyms=None,
    fid_special_chars=None,
) -> str:
    """Normalize one line; parenthesized groups become extra '\\n'-separated
    segments (reference behavior on the frwac corpus).

    Segment emission order matches reference text_latin.py:69-78: innermost
    groups are pulled out, the remainder (which may still hold outer parens)
    recurses FIRST — so outer segments precede inner ones in the output.
    """
    opts = dict(
        language=language, lower_case=lower_case, keep_punc=keep_punc,
        extract_parenthesized=extract_parenthesized, safety_checks=safety_checks,
        convert_numbers=convert_numbers,
        fid_acronyms=fid_acronyms, fid_special_chars=fid_special_chars,
    )
    if "\n" in text:
        return "\n".join(format_text_latin(t, **opts) for t in text.split("\n"))
    if extract_parenthesized and "(" in text and ")" in text:
        inner = re.findall(r"\(([^()]*?)\)", text)
        if inner:
            stripped = text
            for g in inner:
                stripped = stripped.replace("(" + g + ")", "", 1)
            if stripped != text:
                parts = [stripped] + inner
                return "\n".join(s for s in (format_text_latin(p, **opts) for p in parts) if s)
    if fid_acronyms is not None:
        for acro in find_acronyms(text):
            if acro not in _ALL_ACRONYMS:
                print(acro, file=fid_acronyms)
                fid_acronyms.flush()
                _ALL_ACRONYMS.append(acro)
    return _format_segment(text, language, lower_case, keep_punc, safety_checks, fid_special_chars, convert_numbers)


def _format_segment(text, language, lower_case, keep_punc, safety_checks, fid_special_chars=None, convert_numbers=True):
    fr = _lang(language) == "fr"
    text = format_special_characters(text)
    from ssak_tpu_torch.text.basic import LATIN_HOMOGLYPHS

    text = "".join(LATIN_HOMOGLYPHS.get(c, c) for c in text)
    text = remove_special_words(text, glue_apostrophe=False)
    text = _REMOVE_CHARS_RE.sub(" ", text)
    # URLs/emails before any punctuation processing
    text = _URL_RE.sub(lambda m: " " + verbalize_url(m.group(0), language) + " ", text)
    text = _EMAIL_RE.sub(lambda m: " " + verbalize_url(m.group(0), language) + " ", text)
    text = apply_abbreviations(text, language)
    text = verbalize_dotted_acronyms(text, language)
    text = verbalize_dates(text, language)
    # glued dots between word characters ("cm.Polyester") -> point/dot
    text = re.sub(r"(?<=[0-9A-Za-zà-ÿÀ-Ÿ])\.(?=[A-Za-zà-ÿÀ-Ÿ])", " point " if fr else " dot ", text)
    # dimension separators: "39 x31x30" -> "39 x 31 x 30"
    text = re.sub(r"(?<=\d)\s*[x×]\s*(?=\d)", " x ", text)
    if convert_numbers:
        text = verbalize_times(text, language)
        text = verbalize_units(text, language)
        text = verbalize_phones(text, language)
        text = verbalize_ordinals(text, language)
        text = verbalize_roman(text, language)
        text = text.replace("+", " plus ")
        text = text.replace("&", " et " if fr else " and ")
        # digit-letter gluings ("5Bbackid" -> "5 Bbackid"); units ran earlier
        text = re.sub(r"(?<=\d)(?=[A-Za-zà-ÿ])", " ", text)
        text = verbalize_numbers(text, language)
    else:
        # reference text_latin.py:190-198 with convert_numbers=False: unglue
        # digits from letters, but re-glue ordinal suffixes ("6 ème" -> "6ème")
        text = re.sub(r"(?<=\d)(?=[A-Za-zà-ÿ])", " ", text)
        if fr:
            text = re.sub(r"([0-9])\s+(ère|ere|er|re|nd|nde|º|ème|eme|e)\b", r"\1\2", text)
        else:
            text = re.sub(r"([0-9])\s+(st|nd|rd|º|th)\b", r"\1\2", text)
    if lower_case:
        text = text.lower()
    # "cm.Polyester"-style glued dots -> point/dot
    text = _DOT_BETWEEN_RE.sub(" point " if fr else " dot ", text)
    if not keep_punc:
        text = _PUNCT_STRIP_RE.sub(" ", text)
        # hyphens between spaces (dashes) go; intra-word hyphens stay
        text = re.sub(r"(^|\s)-+(\s|$)", " ", text)
        text = re.sub(r"\s-+(?=\S)", " ", text)  # " -vous" -> " vous"
        text = re.sub(r"(?<=\S)-+\s", " ", text)
    # final non-latin removal (reference text_latin.py:220), logging removed
    # characters to fid_special_chars — this is what strips ® © ¬ € etc.
    text = _remove_non_latin(text, fid_special_chars)
    text = collapse_whitespace(text)
    if safety_checks and convert_numbers and _NUMBER_RE.search(text):
        logger.warning(f"digits remain after normalization: {text[:120]!r}")
    return text


# --- acronym mining (reference text_latin.py find_acronyms:26) ------------

_ACRONYM_RE = re.compile(r"\b[A-Z][A-Z0-9]{1,}\b")


def find_acronyms(text: str, ignore_first_upper_words: bool = True) -> list:
    """Collect ALL-CAPS acronym tokens from raw (pre-normalization) text.

    Matches reference text_latin.py:26 find_acronyms exactly: leading
    all-uppercase words (e.g. headline starts) are skipped by scanning up to
    the first lowercase character and cutting at the last space before it.
    """
    if not text:
        return []
    i = 0
    if ignore_first_upper_words:
        up = text.upper()
        for j, (a, b) in enumerate(zip(text, up)):
            if a == " ":
                i = j
            if a != b:
                break
    return _ACRONYM_RE.findall(text[i:])
