"""A reader and a writer for the YAML the repository's config files use,
without PyYAML (the GPU host has none).

The reader takes block mappings and block sequences by indentation (a
sequence may sit at its key's indentation, as PyYAML writes it), `#`
comments, plain, single- and double-quoted scalars, flow sequences and flow
mappings (`[0.1, 0.5]`, `['rgb_fine', ...]`, `{}`) and a leading `---`. It
resolves plain scalars as PyYAML's `safe_load` does (YAML 1.1): `~`, `null`
and the empty value are None; yes / no / true / false / on / off in their
three spellings are bools; ints take `_`, 0x, 0b and a leading 0 for octal;
a float needs a dot (`5.` is a float, `1e-3` a string: PyYAML's float
pattern wants `[0-9]*.[0-9]*` and a signed exponent), `.inf` and `.nan`;
anything else, `None` included, is a string. Anchors, tags, block scalars
(`|`, `>`) and multi-document streams are refused.

The writer emits what PyYAML's `safe_dump` emits for a tree of dicts, lists,
strings, numbers, bools and None: block style, sorted keys, sequences at
their key's indentation, floats in PyYAML's spelling; strings are always
single-quoted, so every reader takes them back as strings.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


class YAMLError(ValueError):
    pass


def _sexagesimal(text: str, conv):
    sign = -1 if text.startswith("-") else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + conv(part)
    return sign * value


def _plain(text: str) -> Any:
    """A plain scalar, resolved as PyYAML's SafeLoader resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        body = t.lstrip("+-")
        if ":" in body:
            return _sexagesimal(t, int)
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body != "0" and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t.startswith("-") else math.inf
        if t.endswith(".nan"):
            return math.nan
        if ":" in t:
            return _sexagesimal(t, float)
        return float(t)
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f", "r": "\r",
            "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


def _quoted_end(text: str, i: int) -> int:
    """Index just past the quoted scalar that starts at text[i]."""
    q = text[i]
    j = i + 1
    while j < len(text):
        if q == "'" and text[j] == "'":
            if j + 1 < len(text) and text[j + 1] == "'":
                j += 2
                continue
            return j + 1
        if q == '"' and text[j] == "\\":
            j += 2
            continue
        if q == '"' and text[j] == '"':
            return j + 1
        j += 1
    raise YAMLError(f"unterminated quoted scalar: {text!r}")


def _unquote(text: str) -> str:
    if text[0] == "'":
        return text[1:-1].replace("''", "'")
    out, j, body = [], 0, text[1:-1]
    while j < len(body):
        c = body[j]
        if c != "\\":
            out.append(c)
            j += 1
            continue
        e = body[j + 1]
        width = {"x": 2, "u": 4, "U": 8}.get(e)
        if width:
            out.append(chr(int(body[j + 2 : j + 2 + width], 16)))
            j += 2 + width
        elif e in _ESCAPES:
            out.append(_ESCAPES[e])
            j += 2
        else:
            raise YAMLError(f"unknown escape \\{e} in {text!r}")
    return "".join(out)


def _strip_comment(line: str) -> str:
    """The line without a trailing `#` comment (a `#` at the start or after
    whitespace, outside quotes)."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            i = _quoted_end(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _split_flow(body: str) -> List[str]:
    """Items of a flow collection's body, split at top-level commas."""
    items, depth, start, i = [], 0, 0, 0
    while i < len(body):
        c = body[i]
        if c in "'\"":
            i = _quoted_end(body, i)
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == "," and depth == 0:
            items.append(body[start:i].strip())
            start = i + 1
        i += 1
    last = body[start:].strip()
    if last:
        items.append(last)
    return items


def _value(text: str) -> Any:
    """An inline value: a quoted or plain scalar or a flow collection."""
    text = text.strip()
    if not text:
        return None
    if text[0] in "&*!|>%@`":
        raise YAMLError(f"unsupported YAML construct: {text!r}")
    if text[0] in "'\"":
        if _quoted_end(text, 0) != len(text):
            raise YAMLError(f"text after a quoted scalar: {text!r}")
        return _unquote(text)
    if text[0] == "[":
        if text[-1] != "]":
            raise YAMLError(f"unterminated flow sequence: {text!r}")
        return [_value(item) for item in _split_flow(text[1:-1])]
    if text[0] == "{":
        if text[-1] != "}":
            raise YAMLError(f"unterminated flow mapping: {text!r}")
        out = {}
        for item in _split_flow(text[1:-1]):
            k, v = _key_value(item)
            out[k] = _value(v)
        return out
    return _plain(text)


def _key_value(text: str) -> Tuple[Any, str]:
    """(key, rest) of `key: rest` (rest may be empty), the key resolved."""
    i = 0
    if text[0] in "'\"":
        i = _quoted_end(text, 0)
    while i < len(text):
        if text[i] == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            key = text[:i].strip()
            return (_unquote(key) if key[0] in "'\"" else _plain(key)), text[i + 1 :].strip()
        i += 1
    raise YAMLError(f"expected `key: value`, got {text!r}")


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Parser:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise YAMLError("tabs in indentation")
            line = _strip_comment(raw)
            if not line.strip() or line.strip() in ("---", "..."):
                continue
            self.lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
        self.i = 0

    def block(self, indent: int) -> Any:
        """The block node whose lines sit at `indent`."""
        if _is_seq_item(self.lines[self.i][1]):
            return self.sequence(indent)
        return self.mapping(indent)

    def _continued(self, text: str, indent: int) -> str:
        """A plain scalar folded over more-indented lines (PyYAML wraps long ones)."""
        while self.i < len(self.lines) and self.lines[self.i][0] > indent:
            more = self.lines[self.i][1]
            if _is_seq_item(more) or text[:1] in "'\"[{":
                raise YAMLError(f"unsupported continuation line: {more!r}")
            text += " " + more
            self.i += 1
        return text

    def _child(self, indent: int) -> Any:
        """The value of a key or item with nothing after its `:` or `-`."""
        if self.i < len(self.lines):
            nxt_indent, nxt = self.lines[self.i]
            if nxt_indent > indent:
                return self.block(nxt_indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent or _is_seq_item(text):
                raise YAMLError(f"bad indentation at {text!r}")
            key, rest = _key_value(text)
            self.i += 1
            if key in out:
                raise YAMLError(f"duplicate key {key!r}")
            if rest:
                out[key] = _value(self._continued(rest, indent))
            elif self.i < len(self.lines) and self.lines[self.i][0] == indent and _is_seq_item(self.lines[self.i][1]):
                out[key] = self.sequence(indent)  # a sequence at its key's indentation
            else:
                out[key] = self._child(indent)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind != indent or not _is_seq_item(text):
                if ind > indent:
                    raise YAMLError(f"bad indentation at {text!r}")
                break
            self.i += 1
            rest = text[1:].strip()
            if not rest:
                out.append(self._child(indent))
            elif rest[0] not in "'\"[{" and re.search(r":(\s|$)", rest):
                raise YAMLError(f"mappings inside sequences are not supported: {text!r}")
            else:
                out.append(_value(self._continued(rest, indent)))
        return out


def safe_load(text: str) -> Any:
    """The document in `text`, as PyYAML's safe_load reads it."""
    parser = _Parser(text)
    if not parser.lines:
        return None
    first_indent, first = parser.lines[0]
    if len(parser.lines) == 1 and not _is_seq_item(first) and not re.search(r":(\s|$)", first):
        return _value(first)
    node = parser.block(first_indent)
    if parser.i != len(parser.lines):
        raise YAMLError(f"bad indentation at {parser.lines[parser.i][1]!r}")
    return node


def _scalar(v: Any) -> str:
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
        text = repr(v).lower()
        if "." not in text and "e" in text:  # PyYAML's spelling: 1e-05 -> 1.0e-05
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise YAMLError(f"cannot write {type(v).__name__} {v!r}")


def _dump(node: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for k in sorted(node):
            v = node[k]
            key = k if isinstance(k, str) and re.match(r"^[A-Za-z_][A-Za-z0-9_.\-]*$", k) else _scalar(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:")
                _dump(v, indent + 2, out)
            elif isinstance(v, (list, tuple)) and v:
                out.append(f"{pad}{key}:")
                _dump(list(v), indent, out)
            else:
                out.append(f"{pad}{key}: " + ("{}" if isinstance(v, dict) else "[]" if isinstance(v, (list, tuple))
                                              else _scalar(v)))
    else:
        for v in node:
            if isinstance(v, (dict, list, tuple)) and v:
                raise YAMLError("nested collections inside sequences are not supported")
            out.append(f"{pad}- " + ("{}" if isinstance(v, dict) else "[]" if isinstance(v, (list, tuple))
                                     else _scalar(v)))


def safe_dump(data: Any, stream=None):
    """Write `data` (dicts, lists, scalars) as PyYAML's safe_dump would lay it
    out; returns the text when no stream is given."""
    if isinstance(data, dict) and data or isinstance(data, (list, tuple)) and data:
        lines: List[str] = []
        _dump(data if isinstance(data, dict) else list(data), 0, lines)
        text = "\n".join(lines) + "\n"
    else:
        text = ("{}" if isinstance(data, dict) else "[]" if isinstance(data, (list, tuple)) else _scalar(data)) + "\n"
    if stream is None:
        return text
    stream.write(text)
    return None
