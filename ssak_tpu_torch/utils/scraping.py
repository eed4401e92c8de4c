"""Web scraping helpers for corpus harvesting (counterpart of
ssak_tpu.utils.scraping).

Standard-library code, the same as ssak_tpu's: static pages fetched with
urllib and parsed with html.parser (links, visible text, YouTube video ids,
the embedded player response, caption payloads in XML or json3), and the
scraped-transcript CSV format. Pages that need a browser to render are out
of reach.
"""

import os
import re
import urllib.parse
import urllib.request
from html.parser import HTMLParser

DEFAULT_HEADERS = {"User-Agent": "Mozilla/5.0 (compatible; ssak-tpu/0.1)"}


def fetch_page(url: str, timeout: float = 30.0) -> str:
    req = urllib.request.Request(url, headers=DEFAULT_HEADERS)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        charset = resp.headers.get_content_charset() or "utf-8"
        return resp.read().decode(charset, errors="replace")


class _LinkParser(HTMLParser):
    def __init__(self):
        super().__init__()
        self.links = []

    def handle_starttag(self, tag, attrs):
        if tag in ("a", "audio", "source", "video"):
            for name, value in attrs:
                if name in ("href", "src") and value:
                    self.links.append(value)


def find_all_links(url_or_html: str, base_url: str = None, pattern: str = None):
    """All links on a page (absolute URLs), optionally regex-filtered."""
    if url_or_html.startswith(("http://", "https://")):
        html = fetch_page(url_or_html)
        base_url = base_url or url_or_html
    else:
        html = url_or_html
    parser = _LinkParser()
    parser.feed(html)
    links = [urllib.parse.urljoin(base_url, l) if base_url else l for l in parser.links]
    if pattern:
        rx = re.compile(pattern)
        links = [l for l in links if rx.search(l)]
    seen = set()
    out = []
    for l in links:
        if l not in seen:
            seen.add(l)
            out.append(l)
    return out


def download_link_to_file(url: str, output_path: str, overwrite: bool = False, timeout: float = 300.0) -> str:
    if os.path.exists(output_path) and not overwrite:
        return output_path
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    req = urllib.request.Request(url, headers=DEFAULT_HEADERS)
    tmp = output_path + ".part"
    with urllib.request.urlopen(req, timeout=timeout) as resp, open(tmp, "wb") as f:
        while True:
            chunk = resp.read(1 << 16)
            if not chunk:
                break
            f.write(chunk)
    os.replace(tmp, output_path)
    return output_path


def extract_text(html: str) -> str:
    """Visible text from an HTML page (script/style stripped)."""

    class _Text(HTMLParser):
        def __init__(self):
            super().__init__()
            self.parts = []
            self._skip = 0

        def handle_starttag(self, tag, attrs):
            if tag in ("script", "style"):
                self._skip += 1

        def handle_endtag(self, tag):
            if tag in ("script", "style") and self._skip:
                self._skip -= 1

        def handle_data(self, data):
            if not self._skip and data.strip():
                self.parts.append(data.strip())

    p = _Text()
    p.feed(html)
    return "\n".join(p.parts)


# --- YouTube corpus harvesting (reference tools/scraping/scrape_youtube*) ---

_VIDEO_ID_RX = re.compile(r"(?:watch\?v=|/shorts/|/embed/|videoId\"\s*:\s*\")([\w-]{11})")


def extract_video_ids(html_or_url: str) -> list:
    """Unique YouTube video ids from a page's HTML (search results, channel
    page, watch page). Accepts raw HTML or a URL to fetch. Counterpart of
    the reference's selenium-scrolled search_videos_ids
    (scrape_youtube.py:146) on the static page content."""
    html = fetch_page(html_or_url) if html_or_url.startswith("http") else html_or_url
    seen, out = set(), []
    for m in _VIDEO_ID_RX.finditer(html):
        vid = m.group(1)
        if vid not in seen:
            seen.add(vid)
            out.append(vid)
    return out


def extract_player_response(html: str) -> dict:
    """The ytInitialPlayerResponse JSON object embedded in a watch page
    (video metadata + caption track list)."""
    import json

    m = re.search(r"ytInitialPlayerResponse\s*=\s*({.+?})\s*;", html, re.S)
    if not m:
        return {}
    # balance braces: the regex may stop at an inner '};'
    s = html[m.start(1):]
    depth = 0
    for i, ch in enumerate(s):
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return json.loads(s[: i + 1])
    return {}


def video_metadata(player_response: dict) -> dict:
    """Title / author / duration / caption-track list out of a player
    response (what the reference pulls via pytube)."""
    details = player_response.get("videoDetails", {})
    captions = (
        player_response.get("captions", {})
        .get("playerCaptionsTracklistRenderer", {})
        .get("captionTracks", [])
    )
    return {
        "video_id": details.get("videoId"),
        "title": details.get("title"),
        "author": details.get("author"),
        "duration_seconds": float(details.get("lengthSeconds", 0) or 0),
        "caption_tracks": [
            {
                "language_code": t.get("languageCode"),
                "url": t.get("baseUrl"),
                "is_automatic": t.get("kind") == "asr" or "auto" in (t.get("name", {}).get("simpleText", "") or "").lower(),
            }
            for t in captions
        ],
    }


def parse_timedtext(content: str) -> list:
    """Parse a YouTube timedtext caption payload into
    [(text, start_seconds, duration_seconds)]. Handles both the XML format
    (<text start=".." dur="..">) and the json3 format ({"events": [...]})
    that youtube_transcript_api returns in the reference."""
    import html as html_mod
    import json

    content = content.strip()
    out = []
    if content.startswith("{"):
        data = json.loads(content)
        for ev in data.get("events", []):
            segs = ev.get("segs")
            if not segs or "tStartMs" not in ev:
                continue
            text = "".join(s.get("utf8", "") for s in segs).replace("\n", " ").strip()
            if text:
                out.append((text, ev["tStartMs"] / 1000.0, ev.get("dDurationMs", 0) / 1000.0))
    else:
        for m in re.finditer(r'<text\s+start="([\d.]+)"\s+dur="([\d.]+)"[^>]*>(.*?)</text>', content, re.S):
            text = html_mod.unescape(re.sub(r"<[^>]+>", "", m.group(3))).replace("\n", " ").strip()
            if text:
                out.append((text, float(m.group(1)), float(m.group(2))))
    return out


def write_transcript_csv(segments: list, path: str):
    """Write the reference's scraped-transcript CSV format
    (scrape_youtube_to_kaldi.py:66: header then 'text;start;duration')."""
    import csv

    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, delimiter=";")
        w.writerow(["text", "start", "duration"])
        for text, start, dur in segments:
            w.writerow([text, f"{start:.3f}", f"{dur:.3f}"])


def read_transcript_csv(path: str) -> list:
    import csv

    out = []
    with open(path, encoding="utf-8") as f:
        reader = csv.reader(f, delimiter=";")
        next(reader, None)
        for row in reader:
            if len(row) >= 3:
                out.append((row[0], float(row[1]), float(row[2])))
    return out
