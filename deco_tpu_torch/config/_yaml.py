"""A YAML reader and writer for the subset the run configs use.

The JAX package reads configs with PyYAML's ``safe_load``; the port may not
import PyYAML, so :func:`load` parses the subset that the files under
``configs*/`` use and gives what ``yaml.safe_load`` gives:

- block mappings and sequences at any indentation, a sequence at its
  parent key's indentation, ``- key: value`` items;
- flow sequences and mappings on one line (``[0.9, 0.95]``, ``{}``);
- comments; plain, single-quoted and double-quoted scalars;
- anchors (``&name``) and aliases (``*name``). An alias is the anchored
  object itself, as in PyYAML: ``pred_dataset: *eval`` shares its dict with
  ``eval_dataset``, so editing one edits both;
- PyYAML's YAML 1.1 scalar resolution: a float needs a dot (``1e-4`` is the
  string ``'1e-4'``, ``1.0e-4`` a float), ``yes/no/on/off/true/false`` in
  their three spellings are booleans, ``~``/``null``/empty are None,
  ``0x``/``0b``/leading-``0`` octal and ``_`` separators are ints.

Anything else (block scalars ``|``/``>``, tags, multi-line plain scalars,
several documents, timestamps) raises ``ValueError`` naming the line.

:func:`dump` writes a config back in block style (every string
double-quoted, every float with a dot) so that ``yaml.safe_load(dump(c))
== c``; shared objects are written out in full at each place.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value: str, cast):
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _resolve_int(value: str) -> int:
    v = value.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
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


def _resolve_float(value: str) -> float:
    v = value.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar under PyYAML's YAML 1.1 rules."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _resolve_int(text)
    if _FLOAT.match(text):
        return _resolve_float(text)
    if _TIMESTAMP.match(text):
        raise ValueError(f"YAML timestamps are not supported: {text!r}")
    return text


class _Parser:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indent, text)
        for no, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError(f"line {no}: tab indentation")
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            if body.strip() in ("---", "...") or body.lstrip().startswith("%"):
                raise ValueError(f"line {no}: document markers and directives are not supported")
            indent = len(body) - len(body.lstrip(" "))
            self.lines.append((no, indent, body[indent:]))
        self.pos = 0
        self.anchors: dict = {}

    # ---- helpers ----
    def peek(self):
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def fail(self, msg: str, line=None):
        line = line or self.peek()
        where = f"line {line[0]}: " if line else ""
        raise ValueError(f"{where}{msg}")

    # ---- block structure ----
    def document(self):
        if not self.lines:
            return None
        value = self.node(self.lines[0][1])
        if self.peek() is not None:
            self.fail("unexpected content")
        return value

    def node(self, indent: int):
        line = self.peek()
        if _is_item(line[2]):
            return self.sequence(line[1])
        if _split_key(line[2]) is not None:
            return self.mapping(line[1])
        self.pos += 1
        return self.inline_value(line[2], line, line[1])

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line[1] < indent:
                return out
            if line[1] > indent:
                self.fail("bad indentation in a mapping")
            if _is_item(line[2]):
                return out  # a sequence at this indentation belongs to the parent
            split = _split_key(line[2])
            if split is None:
                self.fail("expected 'key: value'")
            key_text, rest = split
            self.pos += 1
            key = self.scalar(key_text, line)
            out[key] = self.value(rest, line, indent, in_mapping=True)

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            line = self.peek()
            if line is None or line[1] < indent:
                return out
            if line[1] > indent:
                self.fail("bad indentation in a sequence")
            if not _is_item(line[2]):
                return out
            rest = line[2][1:]
            content = rest.lstrip(" ")
            if not content:
                self.pos += 1
                out.append(self.value("", line, indent, in_mapping=False))
                continue
            anchor, content = _take_anchor(content)
            column = indent + 1 + (len(rest) - len(content))
            if anchor is None and (_is_item(content) or _split_key(content) is not None):
                # "- key: v" / "- - x": the item is a block node whose first line
                # starts at the item's content column
                self.lines[self.pos] = (line[0], column, content)
                out.append(self.node(column))
            else:
                self.pos += 1
                out.append(self.value(line[2][1:].lstrip(" "), line, indent, in_mapping=False))

    def value(self, rest: str, line, indent: int, in_mapping: bool):
        """The value after ``key:`` or ``-``: inline, or a block node below."""
        rest = rest.strip()
        anchor, rest = _take_anchor(rest)
        if _is_item(rest):
            self.fail("a sequence entry cannot follow 'key:' on its line", line)
        if rest:
            value = self.inline_value(rest, line, indent)
        else:
            nxt = self.peek()
            if nxt is not None and nxt[1] > indent:
                value = self.node(nxt[1])
            elif nxt is not None and in_mapping and nxt[1] == indent and _is_item(nxt[2]):
                value = self.sequence(indent)
            else:
                value = None
        if anchor is not None:
            self.anchors[anchor] = value
        return value

    def inline_value(self, text: str, line, indent: int):
        nxt = self.peek()
        if nxt is not None and nxt[1] > indent and not text.startswith(("[", "{", "*")):
            self.fail("multi-line scalars are not supported", nxt)
        if text.startswith("*"):
            name = text[1:]
            if name not in self.anchors:
                self.fail(f"unknown alias *{name}", line)
            return self.anchors[name]
        if text[0] in "[{":
            value, end = _Flow(text, self, line).parse(0)
            if text[end:].strip():
                self.fail(f"trailing text after a flow collection: {text[end:]!r}", line)
            return value
        if text[0] in "|>!":
            self.fail("block scalars and tags are not supported", line)
        return self.scalar(text, line)

    def scalar(self, text: str, line):
        if text[0] in "'\"":
            value, end = _quoted(text, 0, lambda m: self.fail(m, line))
            if text[end:].strip():
                self.fail(f"trailing text after a quoted scalar: {text[end:]!r}", line)
            return value
        return resolve_plain(text)


class _Flow:
    """One-line flow collections: ``[a, b]``, ``{k: v}``, nested."""

    def __init__(self, text: str, parser: _Parser, line):
        self.text, self.parser, self.line = text, parser, line

    def fail(self, msg):
        self.parser.fail(msg, self.line)

    def skip(self, i: int) -> int:
        while i < len(self.text) and self.text[i] == " ":
            i += 1
        return i

    def parse(self, i: int):
        i = self.skip(i)
        ch = self.text[i] if i < len(self.text) else ""
        if ch == "[":
            out, i = [], self.skip(i + 1)
            while self.text[i:i + 1] != "]":
                item, i = self.parse(i)
                out.append(item)
                i = self.skip(i)
                if self.text[i:i + 1] == ",":
                    i = self.skip(i + 1)
                elif self.text[i:i + 1] != "]":
                    self.fail("expected ',' or ']' in a flow sequence")
            return out, i + 1
        if ch == "{":
            out, i = {}, self.skip(i + 1)
            while self.text[i:i + 1] != "}":
                key, i = self.parse(i)
                i = self.skip(i)
                if self.text[i:i + 1] != ":":
                    self.fail("expected ':' in a flow mapping")
                value, i = self.parse(i + 1)
                out[key] = value
                i = self.skip(i)
                if self.text[i:i + 1] == ",":
                    i = self.skip(i + 1)
                elif self.text[i:i + 1] != "}":
                    self.fail("expected ',' or '}' in a flow mapping")
            return out, i + 1
        if ch in ("'", '"'):
            return _quoted(self.text, i, self.fail)
        if ch == "*":
            j = i + 1
            while j < len(self.text) and self.text[j] not in ",]} ":
                j += 1
            name = self.text[i + 1:j]
            if name not in self.parser.anchors:
                self.fail(f"unknown alias *{name}")
            return self.parser.anchors[name], j
        return self.plain(i)

    def plain(self, i: int):
        j = i
        while j < len(self.text) and self.text[j] not in ",]}":
            if self.text[j] == ":" and self.text[j + 1:j + 2] in (" ", ",", "]", "}", ""):
                break
            j += 1
        return resolve_plain(self.text[i:j].strip()), j


def _quoted(text: str, i: int, fail):
    """A quoted scalar starting at ``text[i]``; (value, index after it)."""
    quote = text[i]
    out, j = [], i + 1
    while j < len(text):
        ch = text[j]
        if quote == "'":
            if ch == "'":
                if text[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(ch)
            j += 1
            continue
        if ch == '"':
            return "".join(out), j + 1
        if ch == "\\":
            esc = text[j + 1:j + 2]
            if esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                out.append(chr(int(text[j + 2:j + 2 + n], 16)))
                j += 2 + n
                continue
            if esc not in _ESCAPES:
                fail(f"unknown escape \\{esc}")
            out.append(_ESCAPES[esc])
            j += 2
            continue
        out.append(ch)
        j += 1
    fail("unterminated quoted scalar")


def _strip_comment(line: str) -> str:
    """``line`` without a comment: ``#`` at the start or after a space, outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 2
                continue
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _take_anchor(text: str):
    if text.startswith("&"):
        name, _, rest = text[1:].partition(" ")
        return name, rest.strip()
    return None, text


def _split_key(text: str):
    """(key text, rest) when ``text`` is ``key: ...``; None otherwise."""
    if text[0] in "'\"":
        try:
            _, end = _quoted(text, 0, _raise)
        except ValueError:
            return None
        rest = text[end:].lstrip(" ")
        if rest == ":" or rest.startswith(": "):
            return text[:end], rest[1:]
        return None
    if text[0] in "[{&*|>!":
        return None
    for i, ch in enumerate(text):
        if ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            return text[:i].rstrip(), text[i + 1:]
    return None


def _raise(msg):
    raise ValueError(msg)


def loads(text: str) -> Any:
    """``yaml.safe_load(text)`` for the supported subset."""
    return _Parser(text).document()


def load(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())


# ---- writer ----

def _quote(s: str) -> str:
    out = []
    for ch in s:
        o = ord(ch)
        if ch in '"\\':
            out.append("\\" + ch)
        elif 0x20 <= o < 0x7F:
            out.append(ch)
        elif o < 0x10000:
            out.append(f"\\u{o:04x}")
        else:
            out.append(f"\\U{o:08x}")
    return '"' + "".join(out) + '"'


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r:
            mantissa, exp = r.split("e")
            if "." not in mantissa:
                mantissa += ".0"
            if exp[0] not in "+-":
                exp = "+" + exp
            return f"{mantissa}e{exp}"
        return r
    if isinstance(v, str):
        return _quote(v)
    raise TypeError(f"cannot write {type(v).__name__} to YAML")


def _dump_lines(obj, indent: int) -> List[str]:
    pad = " " * indent
    if isinstance(obj, dict):
        lines = []
        for k, v in obj.items():
            if isinstance(v, (dict, list, tuple)) and v:
                lines.append(f"{pad}{_scalar(k)}:")
                lines.extend(_dump_lines(v, indent + 2))
            else:
                lines.append(f"{pad}{_scalar(k)}: {_inline(v)}")
        return lines
    lines = []
    for item in obj:
        if isinstance(item, (dict, list, tuple)) and item:
            sub = _dump_lines(item, indent + 2)
            lines.append(f"{pad}- {sub[0].lstrip()}")
            lines.extend(sub[1:])
        else:
            lines.append(f"{pad}- {_inline(item)}")
    return lines


def _inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def dump(obj) -> str:
    """Block-style YAML that ``yaml.safe_load`` reads back equal to ``obj``
    (dicts, lists, tuples as lists, str, int, float, bool, None)."""
    if isinstance(obj, (dict, list, tuple)) and obj:
        return "\n".join(_dump_lines(obj, 0)) + "\n"
    return _inline(obj) + "\n"
