"""YAML configs (port of ``neuray_tpu/utils/config.py``): ``load_cfg``
reads the YAML subset that ``configs/`` uses, since the card's machine has
no PyYAML; ``merge_cfg`` lays a config over a class's defaults.

The subset: block mappings and block sequences (items inline, as ``-
key: value`` mappings, or on the lines below a bare ``-``), flow lists
``[a, b]`` and flow mappings ``{k: v}`` on one line, nested, plain,
single- and double-quoted scalars, comments, and a document that is one
plain scalar over several lines (folded with spaces). Plain scalars
resolve as PyYAML's ``FullLoader`` resolves them, which is YAML 1.1:
``true``/``yes``/``on`` and their opposites are bools, ``~``/``null``
and the empty value are None, ``4.0e-4`` is a float while ``1e-4`` (no
dot) and ``4.0e4`` (no exponent sign) stay strings, ``0x1f``, ``0o``-less
octal ``017``, ``0b11`` and ``1_000`` are ints, ``1:30`` is sexagesimal.
Anything else (anchors and aliases, tags, block scalars, multi-line flow
collections, several documents, dates, complex keys) raises
``NotImplementedError``; malformed input raises ``ValueError``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_BOOL = {s: v for v, names in ((True, "yes true on"), (False, "no false off"))
         for name in names.split()
         for s in (name, name.capitalize(), name.upper())}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_UNSUPPORTED_START = "&*!|>%@`?"


def _sexagesimal(parts: List[str]) -> float:
    value = 0.0
    for p in parts:
        value = value * 60 + float(p)
    return value


def _resolve(text: str) -> Any:
    """A plain scalar's value under YAML 1.1's resolvers."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s == "0":
            return 0
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if s.startswith("0"):
            return sign * int(s, 8)
        if ":" in s:
            return sign * int(_sexagesimal(s.split(":")))
        return sign * int(s)
    if _FLOAT.match(text):
        s = text.replace("_", "").lower()
        sign = -1.0 if s[0] == "-" else 1.0
        s = s.lstrip("+-")
        if s == ".inf":
            return sign * float("inf")
        if s == ".nan":
            return float("nan")
        if ":" in s:
            return sign * _sexagesimal(s.split(":"))
        return sign * float(s)
    if _TIMESTAMP.match(text):
        raise NotImplementedError(f"YAML timestamp {text!r}")
    if text == "<<" or text == "=":
        raise NotImplementedError(f"YAML merge or value key {text!r}")
    return text


def _quoted(s: str, pos: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[pos] and the index after it."""
    q = s[pos]
    out, i = [], pos + 1
    while i < len(s):
        c = s[i]
        if q == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = s[i + 1:i + 2]
            simple = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
                      "0": "\0", "r": "\r", " ": " "}
            if e in simple:
                out.append(simple[e])
                i += 2
            elif e in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[e]
                out.append(chr(int(s[i + 2:i + 2 + n], 16)))
                i += 2 + n
            else:
                raise NotImplementedError(f"YAML escape \\{e}")
            continue
        out.append(c)
        i += 1
    raise ValueError(f"unterminated quoted scalar in {s!r}")


def _strip_comment(line: str) -> str:
    """The line without its comment (a '#' at the start or after a
    space, outside quotes)."""
    i, quote = 0, None
    while i < len(line):
        c = line[i]
        if quote:
            if c == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
            elif c == "\\" and quote == '"':
                i += 1
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _flow(s: str, pos: int) -> Tuple[Any, int]:
    """The flow value at s[pos] (a collection or a scalar) and the index
    after it."""
    while pos < len(s) and s[pos] == " ":
        pos += 1
    if pos >= len(s):
        raise ValueError(f"YAML flow collection ends early: {s!r}")
    c = s[pos]
    if c in "[{":
        close = "]" if c == "[" else "}"
        items: Any = [] if c == "[" else {}
        pos += 1
        while True:
            while pos < len(s) and s[pos] == " ":
                pos += 1
            if pos >= len(s):
                raise NotImplementedError(
                    f"YAML flow collection over several lines: {s!r}")
            if s[pos] == close:
                return items, pos + 1
            key, pos = _flow(s, pos)
            while pos < len(s) and s[pos] == " ":
                pos += 1
            if c == "{":
                if s[pos:pos + 1] != ":":
                    raise NotImplementedError(
                        f"YAML flow mapping entry without a value: {s!r}")
                value, pos = _flow(s, pos + 1)
                items[key] = value
            else:
                if s[pos:pos + 1] == ":":
                    raise NotImplementedError(
                        f"YAML single-pair mapping in a flow list: {s!r}")
                items.append(key)
            while pos < len(s) and s[pos] == " ":
                pos += 1
            if s[pos:pos + 1] == ",":
                pos += 1
            elif s[pos:pos + 1] != close:
                raise ValueError(f"YAML flow collection: expected ',' or "
                                 f"{close!r} at {pos} in {s!r}")
    if c in "'\"":
        return _quoted(s, pos)
    if c in _UNSUPPORTED_START:
        raise NotImplementedError(f"YAML construct {c!r} in {s!r}")
    end = pos
    while end < len(s) and s[end] not in ",[]{}" and not (
            s[end] == ":" and (end + 1 == len(s) or s[end + 1] in " ,]}")):
        end += 1
    return _resolve(s[pos:end].strip()), end


def _inline(text: str) -> Any:
    """A value written on one line after 'key:' or '- '."""
    if text[0] in "[{'\"":
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"YAML: text after the value in {text!r}")
        return value
    if text[0] in _UNSUPPORTED_START:
        raise NotImplementedError(f"YAML construct {text[0]!r} in {text!r}")
    if text == "-" or text.startswith("- "):
        raise ValueError(f"YAML: a list entry where a value goes: {text!r}")
    return _resolve(text)


_KEY = re.compile(r"""^(?:'(?:[^']|'')*'|"(?:[^"\\]|\\.)*"|[^'"\s#-][^#]*?
                    |-[^\s#][^#]*?)\s*:(?:\s|$)""", re.X)


def _split_entry(content: str):
    """(key, the text after ':') of a mapping entry line, else None."""
    m = _KEY.match(content)
    if not m:
        return None
    raw = m.group(0).rstrip()[:-1].rstrip()
    if raw[0] in "'\"":
        key, end = _quoted(raw, 0)
        if raw[end:].strip():
            raise ValueError(f"YAML: bad key in {content!r}")
    elif raw[0] in "[{":
        raise NotImplementedError(f"YAML complex key in {content!r}")
    else:
        key = _resolve(raw)
    return key, content[m.end():].strip()


class _Block:
    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines = lines

    def is_item(self, i: int) -> bool:
        c = self.lines[i][1]
        return c == "-" or c.startswith("- ")

    def node(self, i: int, indent: int) -> Tuple[Any, int]:
        if self.is_item(i):
            return self.sequence(i, indent)
        if _split_entry(self.lines[i][1]) is not None:
            return self.mapping(i, indent)
        raise ValueError(f"YAML: expected a mapping or a list at "
                         f"{self.lines[i][1]!r}")

    def child(self, i: int, indent: int, allow_items: bool) -> Tuple[Any, int]:
        """The value of an entry with nothing after its ':' or '-': the
        deeper-indented block below it (or a list at the same indent
        after a key), else None."""
        if i < len(self.lines):
            ind = self.lines[i][0]
            if ind > indent or (allow_items and ind == indent
                                and self.is_item(i)):
                return self.node(i, ind)
        return None, i

    def mapping(self, i: int, indent: int) -> Tuple[Dict, int]:
        out: Dict = {}
        while i < len(self.lines) and self.lines[i][0] >= indent:
            ind, content = self.lines[i]
            if ind > indent:
                raise ValueError(f"YAML: unexpected indent at {content!r}")
            entry = _split_entry(content)
            if entry is None:
                if self.is_item(i):
                    break
                raise ValueError(f"YAML: expected 'key: value' at "
                                 f"{content!r}")
            key, rest = entry
            if rest:
                out[key] = _inline(rest)
                i += 1
                if i < len(self.lines) and self.lines[i][0] > indent:
                    raise NotImplementedError(
                        f"YAML plain scalar over several lines after "
                        f"{content!r}")
            else:
                out[key], i = self.child(i + 1, indent, True)
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[List, int]:
        out: List = []
        while (i < len(self.lines) and self.lines[i][0] == indent
               and self.is_item(i)):
            content = self.lines[i][1]
            rest = content[1:].lstrip()
            if not rest:
                value, i = self.child(i + 1, indent, False)
            elif rest == "-" or rest.startswith("- "):
                raise NotImplementedError(f"YAML nested list on one line: "
                                          f"{content!r}")
            elif _split_entry(rest) is not None and rest[0] not in "[{":
                inner = indent + len(content) - len(rest)
                self.lines[i] = (inner, rest)
                value, i = self.mapping(i, inner)
            else:
                value = _inline(rest)
                i += 1
                if i < len(self.lines) and self.lines[i][0] > indent:
                    raise NotImplementedError(
                        f"YAML plain scalar over several lines after "
                        f"{content!r}")
            out.append(value)
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise ValueError(f"YAML: unexpected indent at "
                             f"{self.lines[i][1]!r}")
        return out, i


def loads(text: str) -> Any:
    """The value of one YAML document in the subset above."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"YAML: a tab in the indentation of {raw!r}")
        content = _strip_comment(raw)
        if not content.strip():
            lines.append(None)
            continue
        stripped = content.lstrip(" ")
        if stripped.startswith(("---", "...", "%")) and (
                content == stripped):
            raise NotImplementedError(f"YAML directive or document marker "
                                      f"{stripped!r}")
        lines.append((len(content) - len(stripped), stripped))
    while lines and lines[-1] is None:
        lines.pop()
    while lines and lines[0] is None:
        lines.pop(0)
    if not lines:
        return None
    first = lines[0][1]
    block = [ln for ln in lines if ln is not None]
    if first.startswith(("- ", "[", "{")) or first == "-" or (
            _split_entry(first) is not None):
        if first[0] in "[{":
            if len(block) > 1:
                raise NotImplementedError("YAML flow collection over "
                                          "several lines")
            return _inline(first)
        parser = _Block(block)
        value, end = parser.node(0, block[0][0])
        if end != len(block):
            raise ValueError(f"YAML: unexpected {block[end][1]!r}")
        return value
    # one plain scalar over several lines, folded with spaces
    if None in lines:
        raise NotImplementedError("YAML scalar with blank lines")
    if first[0] in "'\"":
        if len(block) > 1:
            raise NotImplementedError("YAML quoted scalar over several lines")
        return _inline(first)
    if any(_split_entry(c) is not None or c.startswith("- ")
           for _, c in block):
        raise ValueError("YAML: a scalar followed by mapping entries")
    if first[0] in _UNSUPPORTED_START:
        raise NotImplementedError(f"YAML construct {first[0]!r}")
    return _resolve(" ".join(c for _, c in block))


def load_cfg(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return loads(f.read())


def merge_cfg(default_cfg: Dict[str, Any],
              cfg: Dict[str, Any]) -> Dict[str, Any]:
    return {**default_cfg, **cfg}
