"""Text language identification and content filtering (counterpart of
ssak_tpu.utils.language: `detect_language`, `check_language`,
`is_hate_speech`, `translate_language`).

Host code, the same as ssak_tpu's: stopword and character profiles over the
languages the toolkit normalizes (fr/en/ar/ru + es/de/it), a wordlist flag
for offensive content, and translation through a LibreTranslate-compatible
HTTP service that the caller names (no service is assumed).
"""

import math
import re
from collections import Counter

# characteristic character/word profiles per language
_PROFILES = {
    "fr": {"words": {"le", "la", "les", "de", "des", "un", "une", "et", "est", "que", "qui", "dans", "pour", "pas", "vous", "nous", "je", "il", "elle", "avec", "sur", "ce", "cette", "mais", "être", "avoir", "c'est", "d'un", "d'une", "aussi", "plus"}, "chars": "éèêàçùâîôûëïœ", "script": "latin"},
    "en": {"words": {"the", "of", "and", "to", "in", "is", "that", "it", "for", "was", "with", "are", "this", "have", "from", "not", "they", "his", "her", "you", "but", "what", "which", "there"}, "chars": "", "script": "latin"},
    "es": {"words": {"el", "la", "los", "las", "de", "que", "y", "en", "un", "una", "es", "por", "con", "para", "del", "se", "su", "al", "como", "más", "pero", "sus", "está"}, "chars": "ñáéíóúü¿¡", "script": "latin"},
    "de": {"words": {"der", "die", "das", "und", "ist", "von", "zu", "den", "mit", "nicht", "ein", "eine", "auf", "für", "im", "dem", "sich", "des", "auch", "es", "an", "werden"}, "chars": "äöüß", "script": "latin"},
    "it": {"words": {"il", "la", "di", "che", "e", "un", "una", "per", "in", "è", "non", "sono", "con", "del", "della", "si", "più", "ma", "come", "anche", "questo"}, "chars": "àèéìòù", "script": "latin"},
    "ru": {"words": set(), "chars": "", "script": "cyrillic"},
    "ar": {"words": set(), "chars": "", "script": "arabic"},
}

_CYRILLIC = re.compile(r"[а-яА-ЯёЁ]")
_ARABIC = re.compile(r"[؀-ۿ]")
_LATIN = re.compile(r"[a-zA-Zà-ÿÀ-ß]")


def detect_language(text: str, candidates=None):
    """Returns (language, confidence in [0,1])."""
    text = text.strip()
    if not text:
        return None, 0.0
    n_cyr = len(_CYRILLIC.findall(text))
    n_ar = len(_ARABIC.findall(text))
    n_lat = len(_LATIN.findall(text))
    total = max(1, n_cyr + n_ar + n_lat)
    if n_cyr / total > 0.5:
        return "ru", n_cyr / total
    if n_ar / total > 0.5:
        return "ar", n_ar / total
    # latin languages: score by stopword hits + special chars
    words = re.findall(r"[\wà-ÿÀ-ß']+", text.lower())
    cands = candidates or [l for l, p in _PROFILES.items() if p["script"] == "latin"]
    scores = {}
    for lang in cands:
        prof = _PROFILES.get(lang)
        if prof is None:
            continue
        hits = sum(1 for w in words if w in prof["words"])
        char_hits = sum(1 for c in text if c in prof["chars"])
        scores[lang] = hits / max(1, len(words)) + 0.5 * char_hits / max(1, len(text))
    if not scores or max(scores.values()) == 0:
        return ("en", 0.1) if n_lat else (None, 0.0)
    best = max(scores, key=scores.get)
    total_s = sum(scores.values())
    return best, scores[best] / total_s if total_s else 0.0


def check_language(text: str, language: str, threshold: float = 0.3) -> bool:
    """True when the text plausibly belongs to `language` (reference
    check_language:38 semantics: used to filter scraped corpora)."""
    target = language.split("-")[0].lower()
    lang, conf = detect_language(text)
    if lang is None:
        return False
    if lang == target:
        return True
    if lang in ("ru", "ar") or target in ("ru", "ar"):
        return False  # script mismatch is decisive
    # ambiguous latin text: accept when the target's own profile still
    # scores above the threshold
    words = re.findall(r"[\wà-ÿÀ-ß']+", text.lower())
    prof = _PROFILES.get(target)
    if prof is None or not words:
        return False
    hits = sum(1 for w in words if w in prof["words"])
    return hits / len(words) >= threshold / 2


_OFFENSIVE_FR = {"connard", "connasse", "salope", "enculé", "pute", "nique", "pd", "négro", "bougnoule", "youpin"}
_OFFENSIVE_EN = {"fuck", "shit", "bitch", "cunt", "nigger", "faggot", "whore"}


def is_hate_speech(text: str, language: str = "fr") -> bool:
    """Wordlist heuristic for offensive content (reference is_hate_speech:122
    — used to filter scraped training text, not a moderation system)."""
    words = set(re.findall(r"[\wà-ÿ]+", text.lower()))
    table = _OFFENSIVE_FR if language.startswith("fr") else _OFFENSIVE_EN
    return len(words & table) > 0


def translate_language(text, dest: str, src: str = None, endpoint: str = None, timeout: float = 30.0):
    """Translate text via an HTTP translation service (reference
    translate_language:99 wraps googletrans). The endpoint must be a
    LibreTranslate-compatible POST /translate URL (or set
    SSAK_TRANSLATE_ENDPOINT); offline environments get a clear error
    instead of a silent fallback."""
    import json
    import os
    import urllib.request

    if isinstance(text, str):
        return translate_language([text], dest=dest, src=src, endpoint=endpoint, timeout=timeout)[0]
    endpoint = endpoint or os.environ.get("SSAK_TRANSLATE_ENDPOINT")
    if not endpoint:
        raise RuntimeError(
            "translate_language needs a translation service: pass endpoint= or "
            "set SSAK_TRANSLATE_ENDPOINT to a LibreTranslate-compatible URL"
        )
    out = []
    for t in text:
        body = json.dumps({"q": t, "source": src or "auto", "target": dest, "format": "text"}).encode()
        req = urllib.request.Request(endpoint, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out.append(json.loads(resp.read().decode())["translatedText"])
    return out
