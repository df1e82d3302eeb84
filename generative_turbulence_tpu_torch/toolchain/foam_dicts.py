"""OpenFOAM dictionary parser / serializer (hand-rolled recursive descent).

Covers the FoamFile dialect the LES pipeline needs (same scope as the
reference's lark grammar, ``turbdiff/openfoam.lark`` + ``turbdiff/openfoam.py``):
``key value;`` entries, nested dictionaries, ``( ... )`` lists (nested),
dimension sets ``[0 2 -1 0 0 0 0]``, dimensioned values, ``uniform`` /
``nonuniform List<T>`` fields, macros (``$var``), directives (``#include``),
line and block comments.

The parse result maps to plain Python types (dict / list / int / float / str)
plus three small wrappers that preserve OpenFOAM syntax on re-serialization.

A copy of ``generative_turbulence_tpu/toolchain/foam_dicts.py`` (host code,
no JAX): the same names, defaults and results.
"""

from __future__ import annotations

import contextlib
import re
from pathlib import Path
from typing import Any, List, Optional, Tuple, Union


class FoamDict(dict):
    """An OpenFOAM dictionary (ordered; plain dict subclass)."""


class FoamList(list):
    """A ``( ... )`` list."""


class Dimensioned:
    """A dimension set, optionally with a value: ``[0 2 -1 0 0 0 0] 1e-05``."""

    def __init__(self, exponents: Tuple[float, ...], value: Any = None, name: Optional[str] = None):
        self.exponents = tuple(exponents)
        self.value = value
        self.name = name

    def __repr__(self):
        return f"Dimensioned({self.exponents}, {self.value!r})"

    def __eq__(self, other):
        return (
            isinstance(other, Dimensioned)
            and self.exponents == other.exponents
            and self.value == other.value
        )


class Field:
    """A ``uniform <v>`` or ``nonuniform List<T> ...`` field value."""

    def __init__(self, uniform: bool, value: Any, list_type: Optional[str] = None, count: Optional[int] = None):
        self.uniform = uniform
        self.value = value
        self.list_type = list_type
        self.count = count

    def __repr__(self):
        kind = "uniform" if self.uniform else f"nonuniform List<{self.list_type}>"
        return f"Field({kind}, {self.value!r})"

    def __eq__(self, other):
        return (
            isinstance(other, Field)
            and self.uniform == other.uniform
            and self.value == other.value
        )


class Macro(str):
    """A ``$reference`` macro."""


class Directive:
    """A ``#include``-style directive line."""

    def __init__(self, name: str, argument: str):
        self.name = name
        self.argument = argument

    def __repr__(self):
        return f"Directive(#{self.name} {self.argument})"


_TOKEN_RE = re.compile(
    r"""
    (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<punct>[{}()\[\];])
  | (?P<word>[^\s{}()\[\];"]+)
    """,
    re.VERBOSE | re.DOTALL,
)


def _scan_call_suffix(text: str, start: int) -> Optional[int]:
    """If ``text[start] == '('`` opens a whitespace-free balanced-paren span,
    return the index one past its closing paren, else None.

    OpenFOAM keyword names may be function-call-like — ``div(phi,U)``,
    ``div((nuEff*dev2(T(grad(U)))))`` — and must stay ONE token.  Genuine
    lists always contain whitespace (``(0 1 2)``) or follow whitespace, so
    the no-whitespace rule cleanly separates the two (this also keeps
    compact label-prefixed lists like ``4(0 1 2 3)`` tokenizing as lists)."""
    depth = 0
    i = start
    while i < len(text):
        c = text[i]
        if c in ' \t\r\n;"':
            return None
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    return None


def _tokenize(text: str) -> List[str]:
    tokens = []
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.search(text, pos)
        if m is None:
            break
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        tok = m.group()
        # glue function-call-like suffixes onto words: div(phi,U) etc.
        # (purely numeric words are compact list counts — 1(5) — never keys)
        if (
            m.lastgroup == "word"
            and pos < n
            and text[pos] == "("
            and not tok.lstrip("+-").replace(".", "", 1).isdigit()
        ):
            end = _scan_call_suffix(text, pos)
            if end is not None:
                tok += text[pos:end]
                pos = end
        tokens.append(tok)
    return tokens


def _scalar(tok: str) -> Any:
    if tok.startswith('"'):
        return tok[1:-1]
    if tok.startswith("$"):
        return Macro(tok[1:])
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


class _Parser:
    def __init__(self, tokens: List[str]):
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def expect(self, tok: str):
        got = self.next()
        if got != tok:
            raise ValueError(f"Expected {tok!r}, got {got!r} at token {self.pos}")

    # ---- grammar ----------------------------------------------------------

    def parse_dict_body(self, top_level: bool = False) -> FoamDict:
        out = FoamDict()
        while True:
            tok = self.peek()
            if tok is None:
                if top_level:
                    return out
                raise ValueError("Unexpected end of input inside dictionary")
            if tok == "}":
                self.next()
                return out
            if tok.startswith("#"):
                self.next()
                arg = self.next()
                out.setdefault("#directives", []).append(Directive(tok[1:], str(_scalar(arg))))
                continue
            key = str(_scalar(self.next()))
            nxt = self.peek()
            if nxt == "{":
                self.next()
                out[key] = self.parse_dict_body()
            else:
                value = self.parse_value()
                self.expect(";")
                out[key] = value
        return out

    def parse_value(self) -> Any:
        parts: List[Any] = []
        while True:
            tok = self.peek()
            if tok is None or tok == ";":
                break
            if tok == "(":
                parts.append(self.parse_list())
            elif tok == "[":
                parts.append(self.parse_dimensions())
            elif tok == "{":
                self.next()
                parts.append(self.parse_dict_body())
            else:
                parts.append(_scalar(self.next()))
        return self._combine(parts)

    def parse_list(self) -> FoamList:
        self.expect("(")
        items = FoamList()
        while True:
            tok = self.peek()
            if tok is None:
                raise ValueError("Unexpected end of input inside list")
            if tok == ")":
                self.next()
                return items
            if tok == "(":
                items.append(self.parse_list())
            elif tok == "[":
                items.append(self.parse_dimensions())
            elif tok == "{":
                self.next()
                items.append(self.parse_dict_body())
            else:
                items.append(_scalar(self.next()))

    def parse_dimensions(self) -> Dimensioned:
        self.expect("[")
        exps = []
        while self.peek() != "]":
            exps.append(float(self.next()))
        self.expect("]")
        return Dimensioned(tuple(exps))

    @staticmethod
    def _combine(parts: List[Any]) -> Any:
        if not parts:
            return None
        # uniform / nonuniform fields
        if parts[0] == "uniform" and len(parts) == 2:
            return Field(True, parts[1])
        if parts[0] == "nonuniform" and len(parts) >= 2:
            list_type = None
            rest = parts[1:]
            if isinstance(rest[0], str) and rest[0].startswith("List<"):
                list_type = rest[0][5:-1]
                rest = rest[1:]
            count = None
            if rest and isinstance(rest[0], int):
                count = rest[0]
                rest = rest[1:]
            value = rest[0] if rest else FoamList()
            return Field(False, value, list_type=list_type, count=count)
        # dimensioned values: [dims] value  or  name [dims] value
        for i, p in enumerate(parts):
            if isinstance(p, Dimensioned) and p.value is None:
                name = parts[i - 1] if i == 1 and isinstance(parts[0], str) else None
                value = parts[i + 1] if i + 1 < len(parts) else None
                if name is not None or value is not None:
                    return Dimensioned(p.exponents, value, name=name)
        if len(parts) == 1:
            return parts[0]
        return parts


def parse_foam(text: str) -> FoamDict:
    return _Parser(_tokenize(text)).parse_dict_body(top_level=True)


def parse_foam_file(path: Union[str, Path]) -> FoamDict:
    return parse_foam(Path(path).read_text())


# ---- serialization ----------------------------------------------------------


def _ser_value(value: Any) -> str:
    if isinstance(value, Field):
        if value.uniform:
            return f"uniform {_ser_value(value.value)}"
        type_part = f" List<{value.list_type}>" if value.list_type else ""
        count_part = f"\n{value.count}\n" if value.count is not None else " "
        return f"nonuniform{type_part}{count_part}{_ser_value(value.value)}"
    if isinstance(value, Dimensioned):
        exps = " ".join(_num(e) for e in value.exponents)
        parts = []
        if value.name is not None:
            parts.append(str(value.name))
        parts.append(f"[{exps}]")
        if value.value is not None:
            parts.append(_ser_value(value.value))
        return " ".join(parts)
    if isinstance(value, Macro):
        return f"${value}"
    if isinstance(value, FoamList) or isinstance(value, (list, tuple)):
        return "(" + " ".join(_ser_value(v) for v in value) + ")"
    if isinstance(value, FoamDict) or isinstance(value, dict):
        inner = _ser_dict(value, indent=1)
        return "{\n" + inner + "}"
    if isinstance(value, bool):
        return "yes" if value else "no"
    if isinstance(value, float):
        return _num(value)
    return str(value)


def _num(x: float) -> str:
    if float(x) == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(float(x))


def _ser_dict(d: dict, indent: int = 0) -> str:
    pad = "    " * indent
    lines = []
    for key, value in d.items():
        if key == "#directives":
            for directive in value:
                lines.append(f"{pad}#{directive.name} {directive.argument}")
            continue
        if isinstance(value, dict):
            inner = _ser_dict(value, indent + 1)
            lines.append(f"{pad}{key}\n{pad}{{\n{inner}{pad}}}")
        else:
            lines.append(f"{pad}{key} {_ser_value(value)};")
    return "\n".join(lines) + ("\n" if lines else "")


def serialize_foam(d: dict) -> str:
    return _ser_dict(d)


@contextlib.contextmanager
def edit_foam_file(path: Union[str, Path]):
    """Parse, yield for mutation, re-serialize (like the reference's
    ``edit_openfoam_dict``, ``turbdiff/openfoam.py:193-197``)."""
    path = Path(path)
    d = parse_foam_file(path)
    yield d
    path.write_text(serialize_foam(d))
