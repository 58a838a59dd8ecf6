"""Reader and writer for the subset of YAML that the recipes under
``configs/`` use, so the port reads them without PyYAML.

What is read, as PyYAML's ``safe_load`` reads it:

- block mappings by indentation, with plain, single-quoted or integer keys;
- block sequences (``- 0.05``, also at the indentation of their key) and
  one-line flow sequences (``[0.05, 0.1]``) of scalars;
- the empty flow collections ``{}`` and ``[]``;
- scalars by the YAML 1.1 resolver: ``null``/``~``/empty, the booleans
  (``True``, ``false``, ``yes``, ``off`` ...), ints (decimal, ``0x``,
  ``0o``-style octal ``017``, ``0b``) and floats (``0.0001``, ``100.0``,
  ``1.0e-4``, ``.inf``, ``.nan``); ``1e-4``, without a dot, is a string, as
  in PyYAML; every other plain scalar (``None`` too) is a string;
- single-quoted strings (``''`` for a quote);
- full-line and trailing comments.

Anything else (anchors and aliases, tags, block scalars, multi-line
scalars, flow mappings, double quotes, tabs, documents) raises ``ValueError``
naming the line.  :func:`dump` writes the same subset, so what it writes
reads back equal.
"""
from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

__all__ = ["load", "loads", "dump", "dumps"]

_BOOLS = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+)$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.]*$")
# characters a plain scalar may not start with (the YAML indicators)
_INDICATORS = set("&*!|>{}%@`\"")


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _fail(no: int, what: str):
    raise ValueError(f"line {no}: {what} (outside the YAML subset the recipes use)")


def _strip_comment(raw: str, no: int) -> str:
    """The line without its comment: a ``#`` at the start or after
    whitespace, outside single quotes."""
    quoted = False
    for i, ch in enumerate(raw):
        if ch == "'":
            quoted = not quoted
        elif ch == "#" and not quoted and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i].rstrip()
    if quoted:
        _fail(no, "an unterminated single-quoted string")
    return raw.rstrip()


def _lines(text: str) -> List[_Line]:
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw, no)
        if not body.strip():
            continue
        if "\t" in body:
            _fail(no, "a tab")
        stripped = body.lstrip(" ")
        if stripped.startswith(("---", "...")) and (len(stripped) == 3 or stripped[3] == " "):
            _fail(no, "a document marker")
        out.append(_Line(no, len(body) - len(stripped), stripped))
    return out


def _int(s: str) -> int:
    v = s.replace("_", "")
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
    return sign * int(v)


def _float(s: str) -> float:
    v = s.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    return sign * float(v)


def _plain(s: str, no: int) -> Any:
    """A plain scalar resolved as PyYAML's YAML 1.1 resolver does."""
    if s[0] in _INDICATORS:
        _fail(no, f"the plain scalar {s!r}")
    if s in _NULLS:
        return None
    if s in _BOOLS:
        return _BOOLS[s]
    if _SEXAGESIMAL.match(s):
        _fail(no, f"the base-60 number {s!r}")
    if _INT.match(s):
        return _int(s)
    if _FLOAT.match(s):
        return _float(s)
    if ": " in s or s.endswith(":") or " #" in s:
        _fail(no, f"the plain scalar {s!r}")
    return s


def _quoted(s: str, no: int) -> Tuple[str, str]:
    """A single-quoted string at the start of ``s`` -> (value, rest)."""
    out, i = [], 1
    while True:
        j = s.find("'", i)
        if j < 0:
            _fail(no, "an unterminated single-quoted string")
        out.append(s[i:j])
        if s[j + 1 : j + 2] == "'":
            out.append("'")
            i = j + 2
            continue
        return "".join(out), s[j + 1 :]


def _flow_seq(s: str, no: int) -> Tuple[list, str]:
    """A flow sequence at the start of ``s`` (``[``) -> (items, rest)."""
    items, rest = [], s[1:].lstrip()
    if rest.startswith("]"):
        return items, rest[1:]
    while True:
        if rest.startswith("["):
            item, rest = _flow_seq(rest, no)
        elif rest.startswith("'"):
            item, rest = _quoted(rest, no)
        else:
            m = re.match(r"[^,\[\]{}]*", rest)
            token = m.group(0).strip()
            if not token:
                _fail(no, "an empty or nested flow item")
            item, rest = _plain(token, no), rest[m.end():]
        items.append(item)
        rest = rest.lstrip()
        if rest.startswith("]"):
            return items, rest[1:]
        if not rest.startswith(","):
            _fail(no, "a flow sequence that does not end on its line")
        rest = rest[1:].lstrip()


def _scalar(s: str, no: int) -> Any:
    """An inline value: a scalar or a one-line flow collection."""
    if s.startswith("'"):
        value, rest = _quoted(s, no)
    elif s.startswith("["):
        value, rest = _flow_seq(s, no)
    elif s == "{}":
        value, rest = {}, ""
    else:
        return _plain(s, no)
    if rest.strip():
        _fail(no, f"text after a value: {rest.strip()!r}")
    return value


def _split_key(text: str, no: int) -> Tuple[Any, str]:
    """``key: value`` -> (key, value text); the key plain or single-quoted."""
    if text.startswith("'"):
        key, rest = _quoted(text, no)
        if not rest.startswith(":") or (len(rest) > 1 and rest[1] != " "):
            _fail(no, "a quoted key without ': '")
        return key, rest[1:].strip()
    m = re.match(r"^(.*?):(?: (.*)|)$", text)
    if not m:
        _fail(no, f"not a 'key: value' line: {text!r}")
    return _plain(m.group(1).strip(), no), (m.group(2) or "").strip()


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines, self.i = lines, 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        line = self.peek()
        if line.text.startswith("- ") or line.text == "-":
            return self.sequence(line.indent)
        return self.mapping(line.indent)

    def sequence(self, indent: int) -> list:
        items = []
        while True:
            line = self.peek()
            is_item = line is not None and (line.text.startswith("- ") or line.text == "-")
            if line is None or line.indent < indent or (line.indent == indent and not is_item):
                return items  # an indentless sequence ends at its mapping's next key
            if line.indent > indent:
                _fail(line.no, "a sequence item out of place")
            self.i += 1
            rest = line.text[1:].strip()
            if not rest:
                _fail(line.no, "a nested block in a sequence item")
            if re.match(r"^[^'\[].*?:(?: |$)", rest):
                _fail(line.no, "a mapping in a sequence item")
            items.append(_scalar(rest, line.no))

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                _fail(line.no, "an indentation that opens no block")
            if line.text.startswith("- "):
                _fail(line.no, "a sequence item inside a mapping")
            self.i += 1
            key, rest = _split_key(line.text, line.no)
            if rest:
                out[key] = _scalar(rest, line.no)
                continue
            nxt = self.peek()
            if nxt is not None and (nxt.indent > indent or (
                    nxt.indent == indent and (nxt.text.startswith("- ") or nxt.text == "-"))):
                out[key] = self.block(nxt.indent)
            else:
                out[key] = None


def loads(text: str) -> Any:
    """Parse ``text`` (see the module docstring); an empty document is None."""
    lines = _lines(text)
    if not lines:
        return None
    parser = _Parser(lines)
    if lines[0].indent != 0:
        _fail(lines[0].no, "an indented first line")
    if len(lines) == 1 and ":" not in lines[0].text and not lines[0].text.startswith("-"):
        return _scalar(lines[0].text, lines[0].no)
    value = parser.block(0)
    left = parser.peek()
    if left is not None:
        _fail(left.no, "text after the document's block")
    return value


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


# ------------------------------------------------------------------ writer
def _float_text(v: float) -> str:
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v)
    if "e" in text and "." not in text.split("e")[0]:
        mant, exp = text.split("e")
        text = f"{mant}.0e{exp}"
    return text


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if isinstance(v, str):
        if "\n" in v or "\r" in v:
            raise ValueError(f"a multi-line string {v!r} is outside the YAML subset")
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar_text(x) for x in v) + "]"
    if isinstance(v, dict) and not v:
        return "{}"
    raise TypeError(f"cannot write {type(v).__name__} {v!r} in the YAML subset")


def _key_text(k: Any) -> str:
    if isinstance(k, str):
        if _PLAIN_KEY.match(k) and _plain(k, 0) == k:
            return k
        return _scalar_text(k)
    if isinstance(k, bool) or not isinstance(k, (int, float)) and k is not None:
        raise TypeError(f"cannot write the key {k!r} in the YAML subset")
    return _scalar_text(k)


def _dump_into(out: List[str], value: dict, indent: int):
    pad = " " * indent
    for k, v in value.items():
        if isinstance(v, dict) and v:
            out.append(f"{pad}{_key_text(k)}:")
            _dump_into(out, v, indent + 2)
        else:
            if isinstance(v, (list, tuple)) and any(isinstance(x, dict) for x in v):
                raise TypeError(f"a sequence of mappings under {k!r} is outside the YAML subset")
            out.append(f"{pad}{_key_text(k)}: {_scalar_text(v)}")


def dumps(value: dict) -> str:
    """A mapping as block YAML (nested mappings indented by 2; sequences as
    flow sequences; strings single-quoted) that :func:`loads` and PyYAML's
    ``safe_load`` read back equal."""
    if not isinstance(value, dict):
        raise TypeError("the YAML subset writer takes a mapping")
    out: List[str] = []
    _dump_into(out, value, 0)
    return "\n".join(out) + "\n"


def dump(value: dict, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(value))
