"""A reader of the yaml subset the configuration files under ``configs/`` are
written in, so that a machine without PyYAML reads them.

The subset: block mappings nested by indentation (spaces), flow sequences
``[...]`` (nested, on one line), plain, single- and double-quoted scalars,
comments, and the tag ``!!python/object/apply:eval ["expression"]`` that
detectron2's configs use for computed lists.  Plain scalars resolve as
PyYAML's ``SafeLoader`` resolves them (YAML 1.1: ``True``, ``yes`` and
``on`` are booleans, ``~`` and ``null`` None, ``1e-4`` without a dot a
string, ``0x10`` an int), so ``load`` returns what
``yaml.load(text, Loader=...)`` returns for every file in the subset.  The
tag's expression is evaluated with no builtins but ``range``, ``int`` and
``float``.

Anything outside the subset -- block sequences, flow mappings, block
scalars, anchors and aliases, other tags, several documents, a plain
scalar over several lines, tabs in the indentation -- raises
``YamlSubsetError`` with the file and line; nothing is guessed.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

EVAL_TAG = "!!python/object/apply:eval"
EVAL_NAMESPACE = {"__builtins__": {}, "range": range, "int": int, "float": float}

# PyYAML's implicit resolvers (yaml/resolver.py), in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_UNSUPPORTED = re.compile(r"""^(?:<<|=
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+).*)$""", re.X)
_TRUE = {"yes", "true", "on"}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# what a plain scalar may not start with: indicators of constructs outside the subset
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


class YamlSubsetError(ValueError):
    """A construct outside the subset, or malformed yaml, at ``source:line``."""

    def __init__(self, source: str, line: int, what: str):
        super().__init__(f"{source}:{line}: {what}")
        self.source, self.line = source, line


def _sexagesimal(digits: str, last_cast) -> Any:
    value = 0
    base = 1
    for part in reversed(digits.split(":")):
        value += last_cast(part) * base
        base *= 60
    return value


def resolve_plain(text: str, err) -> Any:
    """A plain scalar as PyYAML's SafeLoader constructs it."""
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _NULL.match(text):
        return None
    if _UNSUPPORTED.match(text):
        err(f"the plain scalar {text!r} is a merge key, a value key or a timestamp")
    return text


class _Line:
    """One physical line of the file: text, its number, its indentation."""

    def __init__(self, text: str, number: int, source: str):
        self.text, self.number, self.source = text, number, source
        self.indent = len(text) - len(text.lstrip(" "))

    def error(self, what: str):
        raise YamlSubsetError(self.source, self.number, what)


class _Scanner:
    """The value part of one line, read left to right from ``pos``."""

    def __init__(self, line: _Line, pos: int):
        self.line, self.s, self.pos = line, line.text, pos

    def error(self, what: str):
        self.line.error(what)

    def skip_spaces(self) -> None:
        while self.pos < len(self.s) and self.s[self.pos] in " \t":
            self.pos += 1

    def at_end(self) -> bool:
        """Nothing but spaces and a comment left."""
        self.skip_spaces()
        return self.pos >= len(self.s) or self.s[self.pos] == "#"

    def expect_end(self, after: str) -> None:
        if not self.at_end():
            self.error(f"{self.s[self.pos:]!r} after {after}")

    def double_quoted(self) -> str:
        out, i, s = [], self.pos + 1, self.s
        while True:
            if i >= len(s):
                self.error("a double-quoted scalar over several lines")
            c = s[i]
            if c == '"':
                self.pos = i + 1
                return "".join(out)
            if c == "\\":
                i += 1
                e = s[i] if i < len(s) else ""
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = s[i + 1:i + 1 + n]
                    if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                        self.error(f"a bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += n
                else:
                    self.error(f"the escape \\{e} in a double-quoted scalar"
                               if e else "a double-quoted scalar over several lines")
            else:
                out.append(c)
            i += 1

    def single_quoted(self) -> str:
        out, i, s = [], self.pos + 1, self.s
        while True:
            if i >= len(s):
                self.error("a single-quoted scalar over several lines")
            if s[i] == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                self.pos = i + 1
                return "".join(out)
            out.append(s[i])
            i += 1

    def quoted(self) -> str:
        return self.double_quoted() if self.s[self.pos] == '"' else self.single_quoted()

    def flow_sequence(self) -> List[Any]:
        """A ``[...]`` sequence that closes on this line."""
        items, s = [], self.s
        self.pos += 1
        while True:
            self.skip_spaces()
            if self.pos >= len(s) or s[self.pos] == "#":
                self.error("a flow sequence that does not close on its line")
            c = s[self.pos]
            if c == "]":
                self.pos += 1
                return items
            if c == "[":
                items.append(self.flow_sequence())
            elif c in "\"'":
                items.append(self.quoted())
            elif c in "{":
                self.error("a flow mapping")
            elif c in _INDICATORS and not (c in "-?:" and s[self.pos + 1:self.pos + 2] not in
                                          ("", " ", ",", "]")):
                self.error(f"{c!r} opening an item of a flow sequence")
            else:
                start = self.pos
                while self.pos < len(s) and s[self.pos] not in ",[]{}" and not (
                        s[self.pos] == "#" and s[self.pos - 1] in " \t"):
                    if s[self.pos] == ":" and s[self.pos + 1:self.pos + 2] in (" ", ",", "]", ""):
                        self.error("a mapping inside a flow sequence")
                    self.pos += 1
                text = s[start:self.pos].rstrip(" \t")
                if not text:
                    self.error("an empty item in a flow sequence")
                items.append(resolve_plain(text, self.error))
            self.skip_spaces()
            if self.pos < len(s) and s[self.pos] == ",":
                self.pos += 1
            elif not (self.pos < len(s) and s[self.pos] == "]"):
                self.error("a flow sequence item not followed by ',' or ']'")

    def value(self) -> Any:
        """The value after ``key:``; the line holds nothing after it."""
        s = self.s
        c = s[self.pos]
        if s.startswith(EVAL_TAG, self.pos) and s[self.pos + len(EVAL_TAG):][:1] in (" ", "\t"):
            self.pos += len(EVAL_TAG)
            self.skip_spaces()
            if self.pos >= len(s) or s[self.pos] != "[":
                self.error(f"{EVAL_TAG} without a flow sequence")
            args = self.flow_sequence()
            self.expect_end("the tagged sequence")
            if len(args) != 1 or not isinstance(args[0], str):
                self.error(f"{EVAL_TAG} takes one string, got {args!r}")
            try:
                return eval(args[0], dict(EVAL_NAMESPACE))  # noqa: S307 - the configs' own idiom
            except Exception as e:  # noqa: BLE001 - reported with its line
                self.error(f"{EVAL_TAG} {args[0]!r}: {type(e).__name__}: {e}")
        if c == "[":
            out = self.flow_sequence()
            self.expect_end("the flow sequence")
            return out
        if c in "\"'":
            out = self.quoted()
            self.expect_end("the quoted scalar")
            return out
        if c == "!":
            self.error(f"the tag {s[self.pos:].split()[0]!r}")
        if c in "&*":
            self.error("an anchor or an alias")
        if c in "|>":
            self.error("a block scalar")
        if c == "{":
            self.error("a flow mapping")
        if c in _INDICATORS and not (c in "-?:" and s[self.pos + 1:self.pos + 2] not in
                                    ("", " ", "\t")):
            self.error(f"{c!r} opening a value")
        end = len(s)
        for m in re.finditer(r"[ \t]#", s[self.pos:]):
            end = self.pos + m.start()
            break
        text = s[self.pos:end].rstrip(" \t")
        if re.search(r":(?:[ \t]|$)", text):
            self.error("a mapping as the value of a mapping entry on one line")
        return resolve_plain(text, self.error)


def _key(line: _Line) -> Tuple[Any, int]:
    """The key of a ``key: value`` line and where its value starts."""
    s, start = line.text, line.indent
    c = s[start]
    if s.startswith("- ", start) or s[start:].rstrip() == "-":
        line.error("a block sequence")
    if s.startswith(("---", "..."), start) and line.indent == 0:
        line.error("a document marker (several documents, or a marked one)")
    if c in "?%":
        line.error("a complex key or a directive")
    if c in "\"'":
        sc = _Scanner(line, start)
        key = sc.quoted()
        if s[sc.pos:sc.pos + 1] != ":" or s[sc.pos + 1:sc.pos + 2] not in ("", " ", "\t"):
            line.error("a quoted key not followed by ': '")
        return key, sc.pos + 1
    if c in _INDICATORS:
        line.error(f"{c!r} opening a line")
    m = re.search(r":(?:[ \t]|$)", s[start:])
    if not m:
        line.error("a line that is not a 'key: value' mapping entry")
    text = s[start:start + m.start()]
    if re.search(r"[ \t]#", text):
        line.error("a line that is not a 'key: value' mapping entry")
    return resolve_plain(text.rstrip(" \t"), line.error), start + m.end()


def _content_lines(text: str, source: str) -> List[_Line]:
    lines = []
    for number, raw in enumerate(text.splitlines(), 1):
        line = _Line(raw.rstrip("\r"), number, source)
        body = line.text.strip(" \t")
        if body and not body.startswith("#"):
            if line.text[line.indent] == "\t":
                line.error("a tab in the indentation")
            lines.append(line)
    return lines


def _block(lines: List[_Line], i: int, indent: int) -> Tuple[dict, int]:
    mapping = {}
    while i < len(lines) and lines[i].indent >= indent:
        line = lines[i]
        if line.indent > indent:
            line.error("indentation deeper than its mapping's")
        key, pos = _key(line)
        i += 1
        sc = _Scanner(line, pos)
        if sc.at_end():
            if i < len(lines) and lines[i].indent > indent:
                value, i = _block(lines, i, lines[i].indent)
            else:
                value = None
        else:
            value = sc.value()
        mapping[key] = value
    return mapping, i


def load(text: str, source: str = "<string>") -> Any:
    """The document of ``text``: a dict (the files' top level is a mapping),
    or None for a file without content, as ``yaml.load`` gives them."""
    lines = _content_lines(text, source)
    if not lines:
        return None
    if lines[0].indent:
        lines[0].error("the top-level mapping is indented")
    mapping, i = _block(lines, 0, 0)
    if i < len(lines):
        lines[i].error("indentation shallower than the top-level mapping's")
    return mapping


def load_file(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return load(f.read(), str(path))
