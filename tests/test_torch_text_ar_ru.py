"""The port's Arabic and Russian normalizers against ssak_tpu's, string for
string: format_text for "ar" (with and without Latin characters, Buckwalter)
and "ru" (lower-cased or not), the cardinals over seeded numbers up to
10^9, Buckwalter transliteration, and the Arabic label augmenter's variants
for seeds 0-9 (the same random.Random calls)."""

import numpy as np
import pytest

from ssak_tpu.text import format_text as j_format
from ssak_tpu.text import ar as JAR
from ssak_tpu.text import numbers as JN
from ssak_tpu.text import ru as JRU
from ssak_tpu_torch.text import format_text
from ssak_tpu_torch.text import ar as AR
from ssak_tpu_torch.text import numbers as N
from ssak_tpu_torch.text import ru as RU

AR_TEXTS = [
    "مرحبا ١٢",
    "مَرْحَبًا",
    "باب",
    "ذهبت إلى السوق، واشتريت 3 تفاحات",
    "هل أنت بخير؟ نعم؛ شكراً «جزيلاً» ...",
    "اشتريت 2500 كتابا و١٩ قلما في 2024",
    "كلمةEnglishمختلطة 42abc",
    "إأآا ى ة ؤ ئ ـــ",
    "١٠٠٠٠٠٠ ۲۳ 1000000000",
    "",
]
RU_TEXTS = [
    "Привет, мир 42!",
    "В 2021 году было 1001 событие — и 3 000 000 рублей.",
    "«Ёлка» (новая): 11, 12, 13, 14, 21, 22, 111.",
    "ТЕСТ test Mixed 5",
    "",
]
# the Latin inputs of tests/test_text.py run through both too: digits, punctuation, mixed scripts
LATIN_MIXED = ["Le 9/02/2008 à 20h30", "plus de 80 % ,", "I have 2 cats & 3 dogs."]


def _numbers():
    rng = np.random.RandomState(0)
    fixed = [0, 1, 2, 3, 9, 10, 11, 12, 19, 20, 21, 99, 100, 101, 110, 200, 999, 1000, 1001, 2000, 2001, 3000, 10000,
             11000, 21000, 100000, 1000000, 2000000, 5000000, 1000000000, 2000000000, 10**9 - 1]
    return fixed + [int(x) for x in rng.randint(0, 10**9 + 1, size=300)] + [int(x) for x in rng.randint(0, 10**4, size=200)]


@pytest.mark.parametrize("kw", [{}, {"keep_latin_chars": False}, {"bw": True}], ids=["default", "no_latin", "buckwalter"])
def test_format_text_ar_matches_jax(kw):
    for raw in AR_TEXTS + LATIN_MIXED:
        assert format_text(raw, "ar", **kw) == j_format(raw, "ar", **kw), raw
        assert format_text(raw, "ar-SA", **kw) == j_format(raw, "ar-SA", **kw), raw


@pytest.mark.parametrize("lower_case", [True, False])
def test_format_text_ru_matches_jax(lower_case):
    for raw in RU_TEXTS + LATIN_MIXED:
        assert format_text(raw, "ru", lower_case=lower_case) == j_format(raw, "ru", lower_case=lower_case), raw


def test_cardinals_match_jax():
    for n in _numbers():
        assert AR.ar_cardinal(n) == JAR.ar_cardinal(n), n
        assert RU.ru_cardinal(n) == JRU.ru_cardinal(n), n
        assert N.cardinal(n, "ru") == JN.cardinal(n, "ru"), n
    for n in (-1, -25, -1000):
        assert AR.ar_cardinal(n) == JAR.ar_cardinal(n) and RU.ru_cardinal(n) == JRU.ru_cardinal(n)


def test_buckwalter_and_helpers_match_jax():
    for raw in AR_TEXTS:
        assert AR.to_buckwalter(raw) == JAR.to_buckwalter(raw)
        assert AR.remove_diacritics(raw) == JAR.remove_diacritics(raw)
        assert AR.normalize_alef_teh(raw) == JAR.normalize_alef_teh(raw)
        assert AR.unglue_scripts(raw) == JAR.unglue_scripts(raw)
        assert AR.digits_to_words_ar(raw) == JAR.digits_to_words_ar(raw)


@pytest.mark.parametrize("seed", range(10))
def test_ar_augmenter_variants_match_jax(seed):
    mine, ref = AR.make_text_augmenter("ar", seed=seed), JAR.make_text_augmenter("ar", seed=seed)
    for raw in AR_TEXTS * 3:
        assert mine(raw) == ref(raw), (seed, raw)


def test_unknown_languages_still_raise():
    with pytest.raises(NotImplementedError):
        AR.make_text_augmenter("fr")
    with pytest.raises(NotImplementedError):
        format_text("hallo", "zz")
    with pytest.raises(ValueError):
        N.cardinal(3, "ar")
