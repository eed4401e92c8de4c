"""Text normalization: language dispatcher (counterpart of ssak_tpu.text).

The port carries its own copies of the Latin-language normalizers (fr, en,
es, it, pt, de); Arabic and Russian come with a later slice and raise
NotImplementedError.
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
    """Normalize text for a Latin-script language."""
    lang = language.split("-")[0].lower() if language else "fr"
    if lang in LATIN_LANGUAGES:
        from ssak_tpu_torch.text.latin import format_text_latin

        return format_text_latin(text, language=lang, **kwargs)
    if lang in ("ar", "ru"):
        raise NotImplementedError(f"text normalization for {lang!r} is not ported yet (ROADMAP.md)")
    raise NotImplementedError(f"no normalizer for language: {language}")


__all__ = [
    "format_text",
    "collapse_whitespace",
    "format_special_characters",
    "remove_punctuations",
    "remove_special_words",
    "transliterate",
]
