"""Number verbalization (the port's own copy of ssak_tpu.text.numbers).

Number verbalization engine: digits → words for fr/en (ru/ar in their
language modules).

From-scratch replacement for the num2words/text2num machinery the reference
leans on (ssak/utils/text_utils.py: cardinal_numbers_to_letters:356,
ordinal_numbers_to_letters:463, roman_numbers_to_letters:489, undigit:578,
robust_num2words:630). Conventions follow num2words so that normalized
corpora remain comparable: French uses 'et' forms and hyphenated tens
("vingt et un", "soixante-treize"), English uses "and" after hundreds.
"""

import re

# --- French ---------------------------------------------------------------

_FR_UNITS = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept", "huit", "neuf", "dix", "onze", "douze", "treize", "quatorze", "quinze", "seize"]
_FR_TENS = {20: "vingt", 30: "trente", 40: "quarante", 50: "cinquante", 60: "soixante"}


def _fr_under_100(n: int) -> str:
    if n < 17:
        return _FR_UNITS[n]
    if n < 20:
        return "dix-" + _FR_UNITS[n - 10]
    if n < 70:
        t, u = divmod(n, 10)
        base = _FR_TENS[t * 10]
        if u == 0:
            return base
        if u == 1:
            return base + " et un"
        return base + "-" + _FR_UNITS[u]
    if n < 80:
        if n == 71:
            return "soixante et onze"
        return "soixante-" + _fr_under_100(n - 60)
    if n == 80:
        return "quatre-vingts"
    if n < 100:
        return "quatre-vingt-" + _fr_under_100(n - 80)
    raise ValueError(n)


def _fr_under_1000(n: int) -> str:
    if n < 100:
        return _fr_under_100(n)
    h, rest = divmod(n, 100)
    if h == 1:
        head = "cent"
    else:
        head = _FR_UNITS[h] + " cent" + ("s" if rest == 0 else "")
    return head if rest == 0 else head + " " + _fr_under_100(rest)


_FR_SCALES = [(10**9, "milliard", True), (10**6, "million", True), (10**3, "mille", False)]


def fr_cardinal(n: int) -> str:
    if n < 0:
        return "moins " + fr_cardinal(-n)
    if n == 0:
        return "zéro"
    parts = []
    for scale, name, pluralize in _FR_SCALES:
        if n >= scale:
            q, n = divmod(n, scale)
            if name == "mille":
                if q == 1:
                    parts.append("mille")
                else:
                    qs = _fr_under_1000(q) if q < 1000 else fr_cardinal(q)
                    # 'quatre-vingts mille' keeps its s? num2words: 'quatre-vingt mille'
                    qs = re.sub(r"vingts$", "vingt", qs)
                    qs = re.sub(r"cents$", "cent", qs)
                    parts.append(qs + " mille")
            else:
                qs = _fr_under_1000(q) if q < 1000 else fr_cardinal(q)
                parts.append(qs + " " + name + ("s" if pluralize and q > 1 else ""))
    if n:
        parts.append(_fr_under_1000(n))
    return " ".join(parts)


def fr_ordinal(n: int) -> str:
    if n == 1:
        return "premier"
    card = fr_cardinal(n)
    if card.endswith("e"):
        card = card[:-1]
    elif card.endswith("q"):  # cinq -> cinquième
        card += "u"
    elif card.endswith("f"):  # neuf -> neuvième
        card = card[:-1] + "v"
    elif card.endswith("s") and n % 10 == 0 and (n % 100 == 80 or card.endswith("cents")):
        card = card[:-1]  # quatre-vingts -> quatre-vingtième
    return card + "ième"


# --- English --------------------------------------------------------------

_EN_UNITS = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]


def _en_under_100(n: int) -> str:
    if n < 20:
        return _EN_UNITS[n]
    t, u = divmod(n, 10)
    return _EN_TENS[t] + ("-" + _EN_UNITS[u] if u else "")


def _en_under_1000(n: int, use_and: bool = True) -> str:
    if n < 100:
        return _en_under_100(n)
    h, rest = divmod(n, 100)
    head = _EN_UNITS[h] + " hundred"
    if rest == 0:
        return head
    return head + (" and " if use_and else " ") + _en_under_100(rest)


_EN_SCALES = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand")]


def en_cardinal(n: int, use_and: bool = True) -> str:
    if n < 0:
        return "minus " + en_cardinal(-n, use_and)
    if n == 0:
        return "zero"
    parts = []
    for scale, name in _EN_SCALES:
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(en_cardinal(q, use_and=False) + " " + name)
    if n:
        if parts and n < 100 and use_and:
            parts.append("and " + _en_under_100(n))
        else:
            parts.append(_en_under_1000(n, use_and))
    return " ".join(parts)


_EN_ORD_IRREG = {"one": "first", "two": "second", "three": "third", "five": "fifth", "eight": "eighth", "nine": "ninth", "twelve": "twelfth"}


def en_ordinal(n: int) -> str:
    card = en_cardinal(n)
    words = card.rsplit(" ", 1)
    last = words[-1]
    if "-" in last:
        tens, unit = last.rsplit("-", 1)
        unit = _EN_ORD_IRREG.get(unit, unit + "th") if not unit.endswith("y") else unit[:-1] + "ieth"
        last = tens + "-" + unit
    elif last in _EN_ORD_IRREG:
        last = _EN_ORD_IRREG[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    words[-1] = last
    return " ".join(words)


# --- generic API ----------------------------------------------------------


def cardinal(n: int, language: str = "fr") -> str:
    lang = language.split("-")[0].lower()
    if lang == "fr":
        return fr_cardinal(n)
    if lang == "en":
        return en_cardinal(n)
    if lang == "ru":
        from ssak_tpu_torch.text.ru import ru_cardinal

        return ru_cardinal(n)
    raise ValueError(f"no cardinal verbalizer for language {language}")


def ordinal(n: int, language: str = "fr") -> str:
    lang = language.split("-")[0].lower()
    if lang == "fr":
        return fr_ordinal(n)
    if lang == "en":
        return en_ordinal(n)
    raise ValueError(f"no ordinal verbalizer for language {language}")


def decimal_to_words(s: str, language: str = "fr") -> str:
    """'3.14' / '3,14' -> 'trois virgule quatorze' / 'three point one four'."""
    lang = language.split("-")[0].lower()
    sep = "virgule" if lang == "fr" else "point"
    s = s.replace(",", ".")
    int_part, _dot, frac = s.partition(".")
    out = cardinal(int(int_part), language)
    if frac:
        if lang == "fr":
            # French reads the fractional part as a number ("quatorze"),
            # keeping leading zeros digit by digit
            i = 0
            digits = []
            while i < len(frac) and frac[i] == "0":
                digits.append(cardinal(0, language))
                i += 1
            if i < len(frac):
                digits.append(cardinal(int(frac[i:]), language))
            out += f" {sep} " + " ".join(digits)
        else:
            out += f" {sep} " + " ".join(cardinal(int(d), language) for d in frac)
    return out


# --- roman numerals -------------------------------------------------------

_ROMAN_RE = re.compile(r"^(?=[MDCLXVI])M{0,4}(CM|CD|D?C{0,3})(XC|XL|L?X{0,3})(IX|IV|V?I{0,3})$")
_ROMAN_VALUES = {"M": 1000, "D": 500, "C": 100, "L": 50, "X": 10, "V": 5, "I": 1}


def roman_to_decimal(s: str):
    """Return int value or None if not a valid roman numeral."""
    if not s or not _ROMAN_RE.match(s.upper()):
        return None
    total = 0
    prev = 0
    for ch in reversed(s.upper()):
        v = _ROMAN_VALUES[ch]
        total += v if v >= prev else -v
        prev = max(prev, v)
    return total
