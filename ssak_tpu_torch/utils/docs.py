"""Text extraction from office documents for corpus harvesting
(counterpart of ssak_tpu.utils.docs: `EXTRACTORS`, `doc2text`).

Standard-library code, the same as ssak_tpu's: DOCX, ODT / ODS and XLSX
read as the zipped XML they are (zipfile + ElementTree), and a best-effort
PDF reader for unencrypted text streams (zlib FlateDecode and the Tj / TJ
text operators).
"""

import os
import re
import zipfile
import zlib


def _localname(tag):
    return tag.rsplit("}", 1)[-1]


def _docx2text(path: str) -> str:
    import xml.etree.ElementTree as ET

    with zipfile.ZipFile(path) as z:
        root = ET.fromstring(z.read("word/document.xml"))
    paragraphs = []
    for p in root.iter():
        if _localname(p.tag) != "p":
            continue
        runs = [el.text or "" for el in p.iter() if _localname(el.tag) == "t"]
        text = "".join(runs).strip()
        if text:
            paragraphs.append(text)
    return "\n".join(paragraphs)


def _odt2text(path: str) -> str:
    import xml.etree.ElementTree as ET

    with zipfile.ZipFile(path) as z:
        root = ET.fromstring(z.read("content.xml"))
    paragraphs = []
    for p in root.iter():
        if _localname(p.tag) in ("p", "h"):
            text = "".join(p.itertext()).strip()
            if text:
                paragraphs.append(text)
    return "\n".join(paragraphs)


def _xlsx2text(path: str) -> str:
    import xml.etree.ElementTree as ET

    with zipfile.ZipFile(path) as z:
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            sroot = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in sroot:
                shared.append("".join(t.text or "" for t in si.iter() if _localname(t.tag) == "t"))
        lines = []
        for name in sorted(n for n in z.namelist() if re.match(r"xl/worksheets/sheet\d+\.xml$", n)):
            root = ET.fromstring(z.read(name))
            for row in root.iter():
                if _localname(row.tag) != "row":
                    continue
                cells = []
                for c in row:
                    if _localname(c.tag) != "c":
                        continue
                    v = next((el.text for el in c.iter() if _localname(el.tag) == "v"), None)
                    if v is None:
                        continue
                    if c.attrib.get("t") == "s":
                        try:
                            v = shared[int(v)]
                        except (ValueError, IndexError):
                            pass
                    cells.append(str(v))
                if cells:
                    lines.append("\t".join(cells))
    return "\n".join(lines)


_PDF_TEXT_OP = re.compile(rb"\((?:[^()\\]|\\.)*\)\s*Tj|\[(?:[^\[\]\\]|\\.)*\]\s*TJ")
_PDF_STR = re.compile(rb"\((?:[^()\\]|\\.)*\)")


def _pdf_unescape(b: bytes) -> str:
    out = []
    i = 0
    while i < len(b):
        c = b[i:i + 1]
        if c == b"\\" and i + 1 < len(b):
            nxt = b[i + 1:i + 2]
            mapping = {b"n": "\n", b"r": "", b"t": " ", b"(": "(", b")": ")", b"\\": "\\"}
            if nxt in mapping:
                out.append(mapping[nxt])
                i += 2
                continue
            if nxt.isdigit():  # octal escape
                oct_digits = re.match(rb"\\([0-7]{1,3})", b[i:])
                if oct_digits:
                    out.append(chr(int(oct_digits.group(1), 8)))
                    i += 1 + len(oct_digits.group(1))
                    continue
            i += 1
            continue
        out.append(c.decode("latin-1"))
        i += 1
    return "".join(out)


def _pdf2text(path: str) -> str:
    """Best-effort: decompress FlateDecode content streams and collect the
    literal strings of Tj/TJ text-showing operators. Works for simple,
    unencrypted PDFs with standard encodings."""
    with open(path, "rb") as f:
        data = f.read()
    chunks = []
    for m in re.finditer(rb"stream\r?\n", data):
        start = m.end()
        end = data.find(b"endstream", start)
        if end < 0:
            continue
        raw = data[start:end].rstrip(b"\r\n")
        try:
            content = zlib.decompress(raw)
        except zlib.error:
            content = raw
        if b"Tj" not in content and b"TJ" not in content:
            continue
        parts = []
        for op in _PDF_TEXT_OP.finditer(content):
            text = "".join(_pdf_unescape(s.group(0)[1:-1]) for s in _PDF_STR.finditer(op.group(0)))
            if text.strip():
                parts.append(text)
        if parts:
            chunks.append(" ".join(parts))
    return "\n".join(chunks)


EXTRACTORS = {
    ".docx": _docx2text,
    ".odt": _odt2text,
    ".ods": _odt2text,
    ".xlsx": _xlsx2text,
    ".xlsm": _xlsx2text,
    ".xltx": _xlsx2text,
    ".xltm": _xlsx2text,
    ".pdf": _pdf2text,
}


def doc2text(path: str) -> str:
    """Extract plain text from a document file (reference doc2text:31)."""
    ext = os.path.splitext(path)[1].lower()
    extractor = EXTRACTORS.get(ext)
    if extractor is None:
        raise ValueError(f"unsupported document type: {ext} ({sorted(EXTRACTORS)})")
    return extractor(path)
