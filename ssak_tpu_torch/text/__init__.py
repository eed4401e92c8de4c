"""Text normalization: language dispatcher (counterpart of ssak_tpu.text).

The port carries its own copies of the normalizers: the Latin-script
languages (fr, en, es, it, pt, de), Arabic and Russian.
"""

from ssak_tpu_torch.text.basic import (
    collapse_whitespace,
    format_special_characters,
    remove_punctuations,
    remove_special_words,
    transliterate,
)

LATIN_LANGUAGES = ("fr", "en", "es", "it", "pt", "de")


def format_text(text: str, language: str, **kwargs) -> str:
    """Normalize text for the given language (fr/en/es/it/pt/de/ar/ru)."""
    lang = language.split("-")[0].lower() if language else "fr"
    if lang in LATIN_LANGUAGES:
        from ssak_tpu_torch.text.latin import format_text_latin

        return format_text_latin(text, language=lang, **kwargs)
    if lang == "ar":
        from ssak_tpu_torch.text.ar import format_text_ar

        return format_text_ar(text, **kwargs)
    if lang == "ru":
        from ssak_tpu_torch.text.ru import format_text_ru

        return format_text_ru(text, **kwargs)
    raise NotImplementedError(f"no normalizer for language: {language}")


__all__ = [
    "format_text",
    "collapse_whitespace",
    "format_special_characters",
    "remove_punctuations",
    "remove_special_words",
    "transliterate",
]
