"""A reader of the YAML that NeMo archives hold (their model_config.yaml),
with no YAML package: the card host has none.

`safe_load(text)` gives what PyYAML's `yaml.safe_load` gives for this
subset of YAML 1.1:
- block mappings and sequences, sequences of mappings and sequences at the
  indentation of their key ("indentless", as `yaml.safe_dump` writes them);
- flow sequences `[...]` and mappings `{...}`, nested, over one or more lines;
- plain scalars (over several lines too), single- and double-quoted ones
  with their escapes and line folding, literal `|` and folded `>` blocks
  with their chomping and indentation indicators;
- comments, a leading `---` and a closing `...`;
- anchors `&name` on block nodes and their aliases `*name` (what
  `yaml.safe_dump` writes for an object that appears twice);
- PyYAML's implicit types of plain scalars: null (`~`, `null`, empty),
  booleans (`true`, `yes`, `on`, ... in three cases), ints (decimal, `0x`,
  `0o`-less octal `017`, `0b`, `_` separators, base 60 `1:30`) and floats
  (`1.0e-05`, `.5`, `.inf`, `.nan`; note that PyYAML reads `1e-5`, with no
  dot, as a string).
Tags, complex `?` keys, anchors inside flow collections and directives
other than a leading `%` line are refused by name (ValueError); a
timestamp-like plain scalar stays a string.
"""

import math
import re

_BOOL_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_BOOL_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}
# PyYAML's implicit resolvers for int and float (yaml/resolver.py)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
            "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(digits: str, cast):
    value = 0
    for part in digits.split(":"):
        value = value * 60 + cast(part)
    return value


def resolve_plain(s: str):
    """The value of a plain scalar, typed as PyYAML's resolvers type it."""
    if s in _NULL:
        return None
    if s in _BOOL_TRUE:
        return True
    if s in _BOOL_FALSE:
        return False
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    return s


def _fold(segments, escaped_breaks=()):
    """Join the lines of a multi-line quoted scalar: a line break becomes a
    space, each empty line between two lines a newline; after an escaped
    break (index in `escaped_breaks`) the next line joins with nothing."""
    out = segments[0]
    i = 1
    while i < len(segments):
        if i - 1 in escaped_breaks:
            out += segments[i]
            i += 1
            continue
        empties = 0
        while i < len(segments) - 1 and segments[i] == "":
            empties += 1
            i += 1
        out += ("\n" * empties if empties else " ") + segments[i]
        i += 1
    return out


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = s[i + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            out.append(chr(int(s[i + 2: i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"yaml: unknown escape \\{e}")
    return "".join(out)


def _scan(text: str, quote=None, depth: int = 0):
    """(text without its comment, open quote at its end, flow depth at its
    end) of one line, starting inside `quote` at `depth`. A quote opens a
    node: at the start, after a flow indicator, or after an indicator `:`,
    `-` or `?` and a space; a comment starts at the start or after a space,
    outside quotes."""
    i, last = 0, None  # last: the previous character that is not a space
    while i < len(text):
        c = text[i]
        if i and text[i - 1] not in " \t":
            last = text[i - 1]
        if quote == "'":
            if c == "'":
                if text[i + 1: i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif quote == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                quote = None
        elif c in "'\"" and (last is None or last in "[{," or (last in ":-?" and text[i - 1] in " \t")):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip(), quote, depth
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return text.rstrip(), quote, depth


def _strip_comment(text: str) -> str:
    return _scan(text)[0]


def _quoted(lines, col: int = 0):
    """(value, lines used, column after the closing quote in the last of
    them) of the quoted scalar that opens at lines[0][col]."""
    q = lines[0][col]
    segments, escaped = [], set()  # raw text of each line; lines that end in an escaped break
    li, line, i, cur = 0, lines[0], col + 1, []
    while True:
        if i >= len(line):
            li += 1
            if li >= len(lines):
                raise ValueError(f"yaml: unterminated quoted scalar {lines[0]!r}")
            seg = "".join(cur)
            if q == '"' and (len(seg) - len(seg.rstrip("\\"))) % 2 == 1:
                seg = seg[:-1]
                escaped.add(len(segments))
            segments.append(seg)
            line, i, cur = lines[li], 0, []
            continue
        c = line[i]
        if q == "'" and c == "'":
            if line[i + 1: i + 2] == "'":
                cur.append("''")
                i += 2
                continue
            break
        if q == '"' and c == "\\":
            cur.append(line[i: i + 2])
            i += 2
            continue
        if q == '"' and c == '"':
            break
        cur.append(c)
        i += 1
    segments.append("".join(cur))
    last = len(segments) - 1
    for k, seg in enumerate(segments):  # a line break takes the spaces around it
        if k > 0:
            seg = seg.lstrip(" \t")
        if k < last and k not in escaped:
            seg = seg.rstrip(" \t")
        segments[k] = seg
    raw = _fold(segments, escaped)
    value = raw.replace("''", "'") if q == "'" else _unescape(raw)
    return value, li + 1, i + 1


class _Reader:
    def __init__(self, text: str):
        self.lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
        self.i = 0
        self.anchors = {}

    # --- lines ------------------------------------------------------------------

    @staticmethod
    def _blank(line: str) -> bool:
        s = line.strip()
        return not s or s.startswith("#")

    def _skip_blank(self):
        while self.i < len(self.lines) and self._blank(self.lines[self.i]):
            self.i += 1

    def _peek(self):
        """(indent, content) of the next non-blank line, or None at the end."""
        self._skip_blank()
        if self.i >= len(self.lines) or self.lines[self.i].rstrip() == "...":
            return None
        line = self.lines[self.i]
        body = line.lstrip(" ")
        return len(line) - len(body), body

    # --- block nodes --------------------------------------------------------------

    def document(self):
        while self.i < len(self.lines) and (self._blank(self.lines[self.i]) or self.lines[self.i].startswith("%")):
            self.i += 1
        if self.i < len(self.lines) and self.lines[self.i].startswith("---"):
            rest = self.lines[self.i][3:].strip()
            if rest and not rest.startswith("#"):
                self.lines[self.i] = " " * 4 + rest
            else:
                self.i += 1
        value = self.block(0)
        if self._peek() is not None:
            raise ValueError(f"yaml: unexpected content at line {self.i + 1}: {self.lines[self.i]!r}")
        return value

    def block(self, min_indent: int):
        nxt = self._peek()
        if nxt is None or nxt[0] < min_indent:
            return None
        ind, body = nxt
        if body == "-" or body.startswith("- "):
            return self.sequence(ind)
        if body[0] not in "&*" and self._key(body) is not None:
            return self.mapping(ind)
        self.i += 1
        return self.inline(body, min_indent, min_indent - 1)

    def sequence(self, ind: int):
        items = []
        while True:
            nxt = self._peek()
            if nxt is None or nxt[0] != ind or not (nxt[1] == "-" or nxt[1].startswith("- ")):
                return items
            rest = nxt[1][1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                self.i += 1
                items.append(self.block(ind + 1))
            else:  # the item starts on the dash's line: read it as a line of its own, further in
                self.lines[self.i] = " " * (len(self.lines[self.i]) - len(rest)) + rest
                items.append(self.block(ind + 1))

    def mapping(self, ind: int):
        out = {}
        while True:
            nxt = self._peek()
            if nxt is None or nxt[0] < ind:
                return out
            if nxt[0] > ind:
                raise ValueError(f"yaml: bad indentation at line {self.i + 1}: {self.lines[self.i]!r}")
            kv = self._key(nxt[1])
            if kv is None:
                if nxt[1] == "?" or nxt[1].startswith("? "):
                    raise ValueError(f"yaml: complex keys are not read: {nxt[1]!r}")
                return out
            key, rest = kv
            self.i += 1
            out[key] = self.value(rest, ind)

    def value(self, rest: str, ind: int):
        """A mapping value whose key sits at `ind`, `rest` the text after its colon."""
        anchor, rest = self._anchor(rest)
        if anchor is not None:
            value = self.value(rest, ind)
            self.anchors[anchor] = value
            return value
        if not _strip_comment(rest):
            nxt = self._peek()
            if nxt is not None and nxt[0] == ind and (nxt[1] == "-" or nxt[1].startswith("- ")):
                return self.sequence(ind)
            return self.block(ind + 1)
        return self.inline(rest, ind + 1, ind)

    def inline(self, text: str, cont_indent: int, parent_indent: int):
        """A node that starts in `text` (its line already consumed): a block
        scalar, a flow collection, a quoted or a plain scalar; its further
        lines are indented at least `cont_indent`."""
        anchor, text = self._anchor(text)
        if anchor is not None:
            value = self.inline(text, cont_indent, parent_indent) if _strip_comment(text) else self.block(cont_indent)
            self.anchors[anchor] = value
            return value
        c = text[0]
        if c == "*":
            name = _strip_comment(text)[1:]
            if name not in self.anchors:
                raise ValueError(f"yaml: alias *{name} of no anchor")
            return self.anchors[name]
        if c in "!?@`%":
            raise ValueError(f"yaml: tags and complex keys are not read: {text!r}")
        if c in "|>":
            return self.block_scalar(text, parent_indent)
        if c in "[{":
            return self.flow(text)
        if c in "'\"":
            value, used, col = _quoted([text] + self.lines[self.i:])
            end = ([text] + self.lines[self.i:])[used - 1][col:]
            self.i += used - 1
            if _strip_comment(end):
                raise ValueError(f"yaml: text after a quoted scalar: {end!r}")
            return value
        parts = [_strip_comment(text)]
        ended = parts[0] != text.rstrip()  # a comment ends a plain scalar
        while not ended and self.i < len(self.lines):
            line = self.lines[self.i]
            if not line.strip():
                parts.append("")
                self.i += 1
                continue
            body = line.lstrip(" ")
            if len(line) - len(body) < cont_indent or body.startswith("#") or body.rstrip() == "...":
                break
            stripped = _strip_comment(body)
            parts.append(stripped)
            self.i += 1
            ended = stripped != body.rstrip()
        while parts and parts[-1] == "":
            parts.pop()
        return resolve_plain(_fold(parts)) if len(parts) > 1 else resolve_plain(parts[0])

    @staticmethod
    def _anchor(text: str):
        """(anchor name or None, the text after it)."""
        if not text.startswith("&"):
            return None, text
        name, _, rest = text[1:].partition(" ")
        return name, rest.lstrip(" ")

    def _key(self, body: str):
        """(key, rest after the colon) when `body` starts a mapping entry, else None."""
        if body[0] in "'\"":
            try:
                key, _, col = _quoted([body])
            except ValueError:  # not closed on its line: not a key
                return None
            end = body[col:].lstrip(" ")
            if end == ":" or end.startswith(": ") or end.startswith(":\t"):
                return key, end[1:].lstrip(" ")
            return None
        if body[0] in "[{#|>" or body == "-" or body.startswith("- ") or body.startswith("? "):
            return None
        text = _strip_comment(body)
        m = re.search(r":(?:\s|$)", text)
        if m is None:
            return None
        return resolve_plain(text[: m.start()].rstrip()), body[m.end():].lstrip(" ")

    def block_scalar(self, header: str, parent_indent: int) -> str:
        h = _strip_comment(header)
        folded, chomp, explicit = h[0] == ">", None, None
        for c in h[1:].strip():
            if c in "+-":
                chomp = c == "+"
            elif c.isdigit():
                explicit = parent_indent + int(c)
            else:
                raise ValueError(f"yaml: bad block scalar header {header!r}")
        raw = []
        content_indent = explicit
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.strip():
                ind = len(line) - len(line.lstrip(" "))
                if content_indent is None:
                    if ind <= parent_indent:
                        break
                    content_indent = ind
                if ind < content_indent:
                    break
            raw.append(line)
            self.i += 1
        content_indent = content_indent or parent_indent + 1
        lines = [ln[content_indent:] if ln.strip() else "" for ln in raw]
        n_text = len(lines)
        while n_text and lines[n_text - 1] == "":
            n_text -= 1
        trailing = len(lines) - n_text
        lead = 0
        while lead < n_text and lines[lead] == "":
            lead += 1
        chunks = ["\n"] * lead
        text_lines = lines[lead:n_text]
        j = 0
        while j < len(text_lines):
            line = text_lines[j]
            chunks.append(line)
            k = j + 1
            while k < len(text_lines) and text_lines[k] == "":
                k += 1
            if k == len(text_lines):
                break
            breaks = k - j - 1
            if folded and line[:1] not in (" ", "\t") and text_lines[k][:1] not in (" ", "\t"):
                chunks.append("\n" * breaks if breaks else " ")
            else:
                chunks.append("\n" + "\n" * breaks)
            j = k
        if text_lines and chomp is not False:
            chunks.append("\n")
        if chomp is True:
            chunks.append("\n" * trailing)
        return "".join(chunks)

    # --- scalars ------------------------------------------------------------------

    def flow(self, text: str):
        """A flow collection that starts in `text`, read on until its brackets close."""
        buf, quote, depth = _scan(text)
        while depth > 0 or quote:
            if self.i >= len(self.lines):
                raise ValueError(f"yaml: unterminated flow collection {text!r}")
            more, quote, depth = _scan(self.lines[self.i].strip(), quote, depth)
            buf += "\n" + more
            self.i += 1
        value, end = _FlowParser(buf).node(0)
        if end.strip():
            raise ValueError(f"yaml: text after a flow collection: {end!r}")
        return value


class _FlowParser:
    """Flow collections over a string whose lines are joined by newlines."""

    def __init__(self, s: str):
        self.s = s

    def _ws(self, i):
        while i < len(self.s) and self.s[i] in " \t\n":
            i += 1
        return i

    def node(self, i):
        """(value, rest of the string) of the flow node at or after i."""
        value, j = self._node(self._ws(i))
        return value, self.s[j:]

    def _node(self, i):
        s = self.s
        c = s[i]
        if c == "[":
            out, i = [], self._ws(i + 1)
            while s[i] != "]":
                v, i = self._node(i)
                out.append(v)
                i = self._ws(i)
                if s[i] == ",":
                    i = self._ws(i + 1)
            return out, i + 1
        if c == "{":
            out, i = {}, self._ws(i + 1)
            while s[i] != "}":
                k, i = self._node(i)
                i = self._ws(i)
                v = None
                if s[i] == ":":
                    i = self._ws(i + 1)
                    if s[i] not in ",}":
                        v, i = self._node(i)
                        i = self._ws(i)
                out[k] = v
                if s[i] == ",":
                    i = self._ws(i + 1)
            return out, i + 1
        if c in "&*!" or (c == "?" and s[i + 1: i + 2] in (" ", "\n", "")):
            raise ValueError(f"yaml: anchors, aliases, tags and complex keys are not read: {s[i:i + 40]!r}")
        if c in "'\"":
            lines = s[i:].split("\n")
            value, used, col = _quoted(lines)
            return value, i + sum(len(ln) + 1 for ln in lines[: used - 1]) + col
        j = i
        while j < len(s) and s[j] not in ",[]{}" and not (s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " \n,[]{}")):
            j += 1
        return resolve_plain(" ".join(p.strip() for p in s[i:j].strip().split("\n"))), j


def safe_load(text):
    """The value of a YAML document (str or UTF-8 bytes), as yaml.safe_load gives it."""
    if isinstance(text, (bytes, bytearray)):
        text = bytes(text).decode("utf-8-sig")
    return _Reader(text).document()
