"""A reader and a writer for the YAML subset that `conf/` uses, in place of
PyYAML's `safe_load` and `safe_dump` (the GPU machine has no PyYAML).

The reader takes block maps and block lists (a list may sit at its key's
indent), flow maps and flow lists that span lines, anchors, aliases and
`<<` merge keys, comments, single- and double-quoted strings and plain
scalars that continue on more-indented lines. Plain scalars resolve as
YAML 1.1 does in `safe_load`: booleans (`true`, `yes`, `on`, ... in three
cases), nulls (`null`, `~`, nothing), ints (decimal, `0b`, `0x`, octal
`0...`, sexagesimal, `_` separators) and floats that have a dot (so `1e-2`
stays a string, as PyYAML reads it). Block scalars (`|`, `>`), tags,
timestamps and more than one document raise `YAMLError`.

`dump` writes a tree of dicts, lists and scalars as block YAML that
`safe_load` reads back to the same tree."""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["YAMLError", "safe_load", "dump"]


class YAMLError(ValueError):
    pass


_BOOL = {v: True for c in ("yes", "true", "on")
         for v in (c, c.capitalize(), c.upper())}
_BOOL.update({v: False for c in ("no", "false", "off")
              for v in (c, c.capitalize(), c.upper())})
_NULL = {"~", "null", "Null", "NULL", ""}
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP_RE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")


def _sexagesimal(digits: str, value_type):
    value = 0
    base = 1
    for part in reversed(digits.split(":")):
        value += value_type(part) * base
        base *= 60
    return value


def _resolve_plain(text: str) -> Any:
    """A plain scalar's value under the YAML 1.1 resolver of safe_load."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_RE.match(text):
        v = text.replace("_", "")
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
    if _FLOAT_RE.match(text):
        v = text.replace("_", "").lower()
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
    if _TIMESTAMP_RE.match(text):
        raise YAMLError(f"timestamps are not supported: {text!r}")
    if text[0] in "!%@`|>":
        raise YAMLError(f"unsupported plain scalar: {text!r}")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_LEN = {"x": 2, "u": 4, "U": 8}


def _quoted(text: str, pos: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[pos] and the index after it."""
    q = text[pos]
    out: List[str] = []
    i = pos + 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e in _HEX_LEN:
                n = _HEX_LEN[e]
                out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            if e not in _ESCAPES:
                raise YAMLError(f"unknown escape \\{e} in {text!r}")
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    raise YAMLError(f"unterminated quoted scalar in {text!r}")


def _strip_comment(line: str) -> str:
    """The line without its comment (a # at its start or after blank
    space, outside quoted scalars)."""
    i = 0
    prev = " "
    while i < len(line):
        c = line[i]
        if c in "'\"" and prev in " \t[{,:-":
            _, i = _quoted(line, i)
            prev = line[i - 1]
            continue
        if c == "#" and prev in " \t":
            return line[:i]
        prev = c
        i += 1
    return line


def _key_split(text: str) -> Optional[Tuple[str, str]]:
    """(key, rest) when the line is a `key: value` map entry (a colon
    followed by a blank or the end, outside quotes and brackets)."""
    if not text or text[0] in "[{":
        return None
    i = 0
    if text[0] in "'\"":
        _, i = _quoted(text, 0)
        if text[i:i + 1] == ":" and text[i + 1:i + 2] in ("", " ", "\t"):
            return text[:i], text[i + 1:]
        return None
    while i < len(text):
        if text[i] == ":" and text[i + 1:i + 2] in ("", " ", "\t"):
            return text[:i].rstrip(), text[i + 1:]
        i += 1
    return None


def _scalar_key(key: str) -> Any:
    if key[:1] in ("'", '"'):
        return _quoted(key, 0)[0]
    return _resolve_plain(key)


class _Flow:
    """Recursive descent over one flow collection (its lines joined)."""

    def __init__(self, text: str, anchors: dict):
        self.t = text
        self.i = 0
        self.anchors = anchors

    def ws(self) -> None:
        while self.i < len(self.t) and self.t[self.i] in " \t\n":
            self.i += 1

    def peek(self) -> str:
        self.ws()
        return self.t[self.i:self.i + 1]

    def node(self, is_key: bool = False) -> Any:
        c = self.peek()
        if c == "&":
            name = self._name()
            value = self.node(is_key)
            self.anchors[name] = value
            return value
        if c == "*":
            name = self._name()
            if name not in self.anchors:
                raise YAMLError(f"unknown alias *{name}")
            return self.anchors[name]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in ("'", '"'):
            value, self.i = _quoted(self.t, self.i)
            return value
        start = self.i
        while self.i < len(self.t):
            ch = self.t[self.i]
            if ch in ",[]{}":
                break
            if ch == ":" and self.t[self.i + 1:self.i + 2] in (
                    "", " ", "\t", "\n", ",", "]", "}"):
                break
            self.i += 1
        return _resolve_plain(self.t[start:self.i].strip())

    def _name(self) -> str:
        self.i += 1
        start = self.i
        while self.i < len(self.t) and self.t[self.i] not in " \t\n,[]{}":
            self.i += 1
        return self.t[start:self.i]

    def _sep(self, close: str) -> bool:
        c = self.peek()
        if c == ",":
            self.i += 1
            return False
        if c == close:
            self.i += 1
            return True
        raise YAMLError(f"expected ',' or {close!r} at {self.t[self.i:]!r}")

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            if self.peek() == "]":
                self.i += 1
                return out
            out.append(self.node())
            if self._sep("]"):
                return out

    def map(self) -> dict:
        self.i += 1
        out: Dict[Any, Any] = {}
        while True:
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.node(is_key=True)
            value = None
            if self.peek() == ":":
                self.i += 1
                if self.peek() not in (",", "}"):
                    value = self.node()
            out[key] = value
            if self._sep("}"):
                return out


def _balanced_end(text: str) -> int:
    """Index just after the flow collection that starts text, or -1 while
    it is still open."""
    depth = 0
    i = 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " \t\n[{,:"):
            _, i = _quoted(text, i)
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    return -1


class _Block:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        docs = 0
        for raw in text.splitlines():
            line = _strip_comment(raw).rstrip()
            if not line.strip():
                continue
            if line in ("---", "...") or line.startswith("--- "):
                docs += 1
                if docs > 1 or line.startswith("--- "):
                    raise YAMLError("more than one document")
                continue
            if line.startswith("%"):
                raise YAMLError(f"directives are not supported: {line!r}")
            body = line.lstrip(" ")
            if body.startswith("\t"):
                raise YAMLError("tabs in indentation")
            self.lines.append((len(line) - len(body), body))
        self.i = 0
        self.anchors: Dict[str, Any] = {}

    @staticmethod
    def _is_item(body: str) -> bool:
        return body == "-" or body.startswith("- ")

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.node(self.lines[0][0])
        if self.i < len(self.lines):
            raise YAMLError(f"unexpected content: {self.lines[self.i][1]!r}")
        return value

    def node(self, indent: int) -> Any:
        ind, body = self.lines[self.i]
        if self._is_item(body):
            return self.seq(ind)
        if _key_split(body) is not None:
            return self.map(ind)
        self.i += 1
        return self.inline(body, ind)

    def map(self, indent: int) -> dict:
        out: Dict[Any, Any] = {}
        merges: List[Any] = []
        while self.i < len(self.lines):
            ind, body = self.lines[self.i]
            if ind != indent or self._is_item(body):
                if ind > indent:
                    raise YAMLError(f"bad indentation: {body!r}")
                break
            split = _key_split(body)
            if split is None:
                raise YAMLError(f"expected a map entry: {body!r}")
            key, rest = split
            self.i += 1
            value = self.value(rest.strip(), indent)
            if key == "<<":
                merges.append(value)
                continue
            out[_scalar_key(key)] = value
        if not merges:
            return out
        maps: List[dict] = []
        for m in merges:
            maps.extend(m if isinstance(m, list) else [m])
        merged: Dict[Any, Any] = {}
        for m in reversed(maps):
            if not isinstance(m, dict):
                raise YAMLError("a merge key needs maps")
            merged.update(m)
        merged.update(out)
        return merged

    def seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, body = self.lines[self.i]
            if ind != indent or not self._is_item(body):
                if ind > indent:
                    raise YAMLError(f"bad indentation: {body!r}")
                break
            rest = body[1:].lstrip(" ")
            if rest and not rest.startswith(("&", "*")) and (
                    _key_split(rest) is not None or self._is_item(rest)):
                # a compact map or list that starts on the item's line
                self.lines[self.i] = (ind + len(body) - len(rest), rest)
                out.append(self.node(ind + 1))
                continue
            self.i += 1
            out.append(self.value(rest, indent))
        return out

    def value(self, rest: str, indent: int) -> Any:
        """The value after `key:` or `-` on a line of `indent`."""
        anchor = None
        if rest.startswith("&"):
            anchor, _, rest = rest[1:].partition(" ")
            rest = rest.strip()
        if not rest:
            value = None
            if self.i < len(self.lines):
                ind, body = self.lines[self.i]
                if ind > indent or (ind == indent and self._is_item(body)):
                    value = self.node(ind)
        else:
            value = self.inline(rest, indent)
        if anchor is not None:
            self.anchors[anchor] = value
        return value

    def inline(self, rest: str, indent: int) -> Any:
        if rest.startswith("*"):
            name = rest[1:]
            if name not in self.anchors:
                raise YAMLError(f"unknown alias *{name}")
            return self.anchors[name]
        if rest[0] in "[{":
            text = rest
            while _balanced_end(text) < 0:
                if self.i >= len(self.lines):
                    raise YAMLError(f"unclosed flow collection: {rest!r}")
                text += "\n" + self.lines[self.i][1]
                self.i += 1
            end = _balanced_end(text)
            if text[end:].strip():
                raise YAMLError(f"content after a flow collection: {text!r}")
            return _Flow(text[:end], self.anchors).node()
        if rest[0] in "'\"":
            value, end = _quoted(rest, 0)
            if rest[end:].strip():
                raise YAMLError(f"content after a quoted scalar: {rest!r}")
            return value
        if rest[0] in "|>":
            raise YAMLError("block scalars are not supported")
        # a plain scalar may continue on more-indented lines
        parts = [rest]
        while self.i < len(self.lines) and self.lines[self.i][0] > indent:
            part = self.lines[self.i][1]
            if _key_split(part) is not None:
                raise YAMLError(f"a map entry inside a plain scalar: {part!r}")
            parts.append(part)
            self.i += 1
        return _resolve_plain(" ".join(parts))


def safe_load(text: str) -> Any:
    """The value of one YAML document in the subset `conf/` uses."""
    return _Block(text).document()


# -- writer -------------------------------------------------------------------

def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "e" in text and "." not in text.split("e")[0]:
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        if "e" in text and text.split("e")[1][0] not in "+-":
            mant, exp = text.split("e")
            text = f"{mant}e+{exp}"
        return text
    if isinstance(value, str):
        out = ['"']
        for c in value:
            if c in '"\\':
                out.append("\\" + c)
            elif c == "\n":
                out.append("\\n")
            elif c == "\t":
                out.append("\\t")
            elif ord(c) < 0x20 or ord(c) == 0x7f:
                out.append(f"\\x{ord(c):02x}")
            else:
                out.append(c)
        out.append('"')
        return "".join(out)
    raise YAMLError(f"cannot write {type(value).__name__}")


def _dump(node: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for k, v in node.items():
            key = _scalar(k)
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{key}:")
                _dump(v, indent + 2, out)
            else:
                out.append(f"{pad}{key}: {_empty_or_scalar(v)}")
    else:
        for v in node:
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}-")
                _dump(v, indent + 2, out)
            else:
                out.append(f"{pad}- {_empty_or_scalar(v)}")


def _empty_or_scalar(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _scalar(v)


def dump(tree: Any) -> str:
    """Block YAML of a tree of dicts, lists and scalars, keys in their
    order."""
    if not isinstance(tree, (dict, list)) or not tree:
        return _empty_or_scalar(tree) + "\n"
    out: List[str] = []
    _dump(tree, 0, out)
    return "\n".join(out) + "\n"
