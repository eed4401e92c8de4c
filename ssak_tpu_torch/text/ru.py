"""Russian text normalization.

Counterpart of reference ssak/utils/text_ru.py (format_text_ru:11):
lowercase, punctuation removal, number verbalization (nominative masculine
cardinals with correct thousand/million declension), latin transliteration
of stray latin tokens left as-is.
"""

import re

from ssak_tpu_torch.text.basic import collapse_whitespace, format_special_characters

_RU_UNITS = ["ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь", "восемь", "девять", "десять", "одиннадцать", "двенадцать", "тринадцать", "четырнадцать", "пятнадцать", "шестнадцать", "семнадцать", "восемнадцать", "девятнадцать"]
_RU_TENS = ["", "", "двадцать", "тридцать", "сорок", "пятьдесят", "шестьдесят", "семьдесят", "восемьдесят", "девяносто"]
_RU_HUNDREDS = ["", "сто", "двести", "триста", "четыреста", "пятьсот", "шестьсот", "семьсот", "восемьсот", "девятьсот"]


def _ru_under_1000(n: int, feminine: bool = False) -> str:
    parts = []
    h, rest = divmod(n, 100)
    if h:
        parts.append(_RU_HUNDREDS[h])
    if rest >= 20:
        t, u = divmod(rest, 10)
        parts.append(_RU_TENS[t])
        if u:
            parts.append(_ru_unit(u, feminine))
    elif rest:
        parts.append(_ru_unit(rest, feminine) if rest < 3 else _RU_UNITS[rest])
    return " ".join(parts)


def _ru_unit(u: int, feminine: bool) -> str:
    if feminine and u == 1:
        return "одна"
    if feminine and u == 2:
        return "две"
    return _RU_UNITS[u]


def _plural(n: int, one: str, few: str, many: str) -> str:
    if n % 100 in (11, 12, 13, 14):
        return many
    if n % 10 == 1:
        return one
    if n % 10 in (2, 3, 4):
        return few
    return many


def ru_cardinal(n: int) -> str:
    if n < 0:
        return "минус " + ru_cardinal(-n)
    if n == 0:
        return "ноль"
    parts = []
    for scale, (one, few, many), fem in (
        (10**9, ("миллиард", "миллиарда", "миллиардов"), False),
        (10**6, ("миллион", "миллиона", "миллионов"), False),
        (10**3, ("тысяча", "тысячи", "тысяч"), True),
    ):
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(_ru_under_1000(q, feminine=fem))
            parts.append(_plural(q, one, few, many))
    if n:
        parts.append(_ru_under_1000(n))
    return " ".join(p for p in parts if p)


def format_text_ru(text: str, lower_case: bool = True, **kwargs) -> str:
    text = format_special_characters(text)
    text = re.sub(r"\d+", lambda m: ru_cardinal(int(m.group(0))), text)
    for p in ".,;:!?\"'()[]{}«»…—–-":
        text = text.replace(p, " ")
    if lower_case:
        text = text.lower()
    return collapse_whitespace(text)
