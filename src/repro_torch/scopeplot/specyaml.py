"""The YAML subset that ScopePlot specs use, read and written with the
standard library.

The reference reads and writes its specs with PyYAML
(``yaml.safe_load``, ``yaml.compose`` for key lines,
``yaml.safe_dump(..., sort_keys=False)``).  The port keeps no such
dependency, so that specs render on a host that has none: this module
reads the subset specs are written in and means by it what
``yaml.safe_load`` means:

  * block mappings and sequences, ``- key: value`` items and
    sequences indented level with their key;
  * flow mappings and sequences (``{label: n, scale: log}``,
    ``[7, 4.5]``), which may nest and span lines;
  * plain, single- and double-quoted scalars, plain and quoted
    scalars folded over several lines;
  * comments, and one leading ``---``.

Plain scalars resolve by PyYAML's YAML 1.1 rules: ``1.0e-9`` is a
float but ``1e-9`` a string; ``yes``, ``on`` and ``true`` are
booleans; ``~``, ``null`` and nothing are None; ``0x1f``, ``017`` and
``1:30`` are ints; ``2026-07-31`` is a date.  Quoted scalars are
strings.

Anything outside the subset raises :class:`SpecError` at its line:
anchors, aliases, tags, block scalars (``|``, ``>``), complex and
merge keys, directives and several documents.  PyYAML would read some
of them; the port refuses them rather than mean something else.
"""
from __future__ import annotations

import bisect
import datetime
import math
import re
from typing import Any, Dict, List, Optional, Tuple


class SpecError(ValueError):
    """A spec failed to parse or validate; message carries ``path:line:``."""

    def __init__(self, path: str, line: int, message: str):
        self.path = path
        self.line = line
        self.message = message
        where = f"{path}:{line}" if line else path
        super().__init__(f"{where}: {message}")


# ---------------------------------------------------------------------------
# implicit types (PyYAML's YAML 1.1 resolvers and safe constructors)
# ---------------------------------------------------------------------------

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
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
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_TIMESTAMP_PARTS = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
    -(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9])
    :(?P<second>[0-9][0-9])(?:\.(?P<fraction>[0-9]*))?
    (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
    (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
#: Plain scalars that PyYAML resolves to a tag its safe loader cannot
#: construct (``<<`` merge keys, ``=`` values): refused here.
_UNSUPPORTED = re.compile(r"^(?:<<|=)$")


def _sexagesimal(text: str, cast) -> Any:
    value = cast(0)
    base = 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _to_int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _to_timestamp(text: str) -> Any:
    m = _TIMESTAMP_PARTS.match(text)
    year, month, day = (int(m.group(k)) for k in ("year", "month", "day"))
    if not m.group("hour"):
        return datetime.date(year, month, day)
    hour, minute, second = (int(m.group(k))
                            for k in ("hour", "minute", "second"))
    fraction = 0
    if m.group("fraction"):
        digits = m.group("fraction")[:6]
        fraction = int(digits + "0" * (6 - len(digits)))
    tzinfo = None
    if m.group("tz_sign"):
        delta = datetime.timedelta(hours=int(m.group("tz_hour")),
                                   minutes=int(m.group("tz_minute") or 0))
        if m.group("tz_sign") == "-":
            delta = -delta
        tzinfo = datetime.timezone(delta)
    elif m.group("tz"):
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, hour, minute, second,
                             fraction, tzinfo=tzinfo)


def resolve(text: str) -> Any:
    """The value ``yaml.safe_load`` gives a plain scalar ``text``."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _to_float(text)
    if _INT.match(text):
        return _to_int(text)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        return _to_timestamp(text)
    return text


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

_BREAKS = "\n"
_SPACE = " \t"
#: A plain scalar may not begin with these (``-``, ``?`` and ``:`` may,
#: when a non-space follows).
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
_FLOW_END = ",[]{}"
_REFUSED = {"&": "anchors", "*": "aliases", "!": "tags",
            "|": "block scalars", ">": "block scalars"}
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Reader:
    def __init__(self, text: str, path: str):
        self.s = text.replace("\r\n", "\n").replace("\r", "\n")
        if self.s.startswith("\ufeff"):
            self.s = self.s[1:]
        self.n = len(self.s)
        self.path = path
        self.starts = [0] + [i + 1 for i, ch in enumerate(self.s)
                             if ch == "\n"]
        self.key_lines: Dict[str, int] = {}

    # -- positions -------------------------------------------------------
    def line(self, pos: int) -> int:
        return bisect.bisect_right(self.starts, min(pos, self.n))

    def col(self, pos: int) -> int:
        return pos - self.starts[self.line(pos) - 1]

    def fail(self, pos: int, message: str):
        raise SpecError(self.path, self.line(pos), message)

    def ch(self, pos: int) -> str:
        return self.s[pos] if pos < self.n else ""

    def spaced(self, pos: int) -> bool:
        """True when ``pos`` holds a space, a break or the end."""
        return pos >= self.n or self.s[pos] in _SPACE + _BREAKS

    def eol(self, pos: int) -> int:
        i = self.s.find("\n", pos)
        return self.n if i < 0 else i

    def skip_inline(self, pos: int) -> int:
        while pos < self.n and self.s[pos] in _SPACE:
            pos += 1
        return pos

    def skip(self, pos: int) -> int:
        """The next content position: past spaces, breaks and comments
        (a ``#`` at a line's start or after a space)."""
        while pos < self.n:
            c = self.s[pos]
            if c == "\n":
                pos += 1
            elif c == "\t" and not self.s[self.starts[self.line(pos) - 1]
                                           :pos].strip(" "):
                rest = self.s[pos:self.eol(pos)].strip()
                if rest and not rest.startswith("#"):
                    self.fail(pos, "a tab cannot indent a spec line")
                pos = self.eol(pos)
            elif c in _SPACE:
                pos += 1
            elif c == "#" and (pos == 0 or self.s[pos - 1] in _SPACE
                               + _BREAKS):
                pos = self.eol(pos)
            else:
                return pos
        return pos

    def end_of_node(self, pos: int) -> int:
        """After a node in block context only a comment may follow on
        its line."""
        q = self.skip_inline(pos)
        if q < self.n and self.s[q] != "\n" and self.s[q] != "#":
            self.fail(q, f"unexpected {self.s[q]!r} after a value")
        return q

    def marker(self, pos: int) -> Optional[str]:
        """``---`` or ``...`` when one starts the line at ``pos``."""
        if self.col(pos) == 0 and self.s.startswith(("---", "..."), pos) \
                and self.spaced(pos + 3):
            return self.s[pos:pos + 3]
        return None

    # -- documents -------------------------------------------------------
    def document(self) -> Any:
        p = self.skip(0)
        if p < self.n and self.s[p] == "%" and self.col(p) == 0:
            self.fail(p, "directives are not supported in a spec")
        if self.marker(p) == "---":
            q = self.skip_inline(p + 3)
            if q < self.n and self.s[q] not in "\n#":
                self.fail(q, "content on the '---' line is not supported "
                             "in a spec")
            p = self.skip(q)
        if p >= self.n:
            return None
        if self.marker(p):
            self.fail(p, "several documents are not supported in a spec")
        value, p = self.block_node(p, -1, root=True)
        p = self.skip(p)
        if p < self.n:
            if self.marker(p):
                self.fail(p, "several documents are not supported in a "
                             "spec")
            self.fail(p, f"unexpected {self.s[p]!r} at the top level")
        return value

    # -- block context ---------------------------------------------------
    def is_entry(self, pos: int) -> bool:
        return self.ch(pos) == "-" and self.spaced(pos + 1)

    def refuse(self, pos: int) -> None:
        c = self.ch(pos)
        if c in _REFUSED:
            self.fail(pos, f"{_REFUSED[c]} ({c!r}) are not supported in a "
                           "spec")
        if c == "?" and self.spaced(pos + 1):
            self.fail(pos, "complex keys ('?') are not supported in a spec")
        if c in "%@`":
            self.fail(pos, f"a plain scalar cannot start with {c!r}")

    def block_node(self, pos: int, parent: int, root: bool = False
                   ) -> Tuple[Any, int]:
        self.refuse(pos)
        indent = self.col(pos)
        if self.is_entry(pos):
            return self.block_seq(pos, indent)
        if self.key_at(pos) is not None:
            return self.block_map(pos, indent, root)
        value, pos = self.inline_node(pos, parent)
        return value, self.end_of_node(pos)

    def key_at(self, pos: int) -> Optional[Tuple[Any, str, int]]:
        """(key, its text, position after its ``:``) when a mapping key
        starts at ``pos``, else None."""
        c = self.ch(pos)
        if c in "[{":
            end = self.flow_end(pos)
            q = self.skip_inline(end)
            if self.ch(q) == ":" and self.spaced(q + 1):
                self.fail(pos, "complex keys are not supported in a spec")
            return None
        if c in "'\"":
            if self.line(self.quoted_end(pos)) != self.line(pos):
                return None
            key, q = self.quoted(pos, -1)
            q = self.skip_inline(q)
            if self.ch(q) == ":" and self.spaced(q + 1):
                return key, key, q + 1
            return None
        q = pos
        end = self.eol(pos)
        while q < end:
            if self.s[q] == ":" and self.spaced(q + 1):
                text = self.s[pos:q].rstrip(_SPACE)
                if _UNSUPPORTED.match(text):
                    self.fail(pos, f"{text!r} keys are not supported in a "
                                   "spec")
                return resolve(text), text, q + 1
            if self.s[q] == "#" and q > pos and self.s[q - 1] in _SPACE:
                return None
            q += 1
        return None

    def block_map(self, pos: int, indent: int, root: bool
                  ) -> Tuple[Dict[Any, Any], int]:
        out: Dict[Any, Any] = {}
        while True:
            self.refuse(pos)
            found = self.key_at(pos)
            if found is None:
                self.fail(pos, "expected a mapping key")
            key, text, q = found
            self.hashable(key, pos)
            if root:
                self.key_lines[text] = self.line(pos)
            q = self.skip_inline(q)
            if q >= self.n or self.s[q] in "\n#":
                nxt = self.skip(q)
                if nxt < self.n and not self.marker(nxt) and (
                        self.col(nxt) > indent
                        or (self.col(nxt) == indent and self.is_entry(nxt))):
                    value, q = self.block_node(nxt, indent)
                else:
                    value = None
            else:
                if self.is_entry(q):
                    self.fail(q, "a block sequence cannot start on its "
                                 "key's line")
                self.refuse(q)
                value, q = self.inline_node(q, indent)
                q = self.end_of_node(q)
            out[key] = value
            nxt = self.skip(q)
            if nxt >= self.n or self.col(nxt) < indent or self.marker(nxt):
                return out, nxt
            if self.col(nxt) > indent:
                self.fail(nxt, "bad indentation of a mapping entry")
            pos = nxt

    def block_seq(self, pos: int, indent: int) -> Tuple[List[Any], int]:
        out: List[Any] = []
        while True:
            q = self.skip_inline(pos + 1)
            if q >= self.n or self.s[q] in "\n#":
                nxt = self.skip(q)
                if nxt < self.n and not self.marker(nxt) \
                        and self.col(nxt) > indent:
                    value, q = self.block_node(nxt, indent)
                else:
                    value = None
            else:
                value, q = self.block_node(q, indent)
            out.append(value)
            nxt = self.skip(q)
            if nxt >= self.n or self.col(nxt) < indent or self.marker(nxt):
                return out, nxt
            if self.col(nxt) > indent:
                self.fail(nxt, "bad indentation of a sequence entry")
            if not self.is_entry(nxt):
                return out, nxt
            pos = nxt

    def hashable(self, key: Any, pos: int) -> None:
        if isinstance(key, (list, dict)):
            self.fail(pos, "a collection cannot be a mapping key")

    # -- scalars and flow collections ------------------------------------
    def inline_node(self, pos: int, parent: int) -> Tuple[Any, int]:
        c = self.ch(pos)
        if c in "[{":
            return self.flow(pos)
        if c in "'\"":
            return self.quoted(pos, parent)
        return self.plain(pos, parent, flow=False)

    def plain(self, pos: int, parent: int, flow: bool) -> Tuple[Any, int]:
        """A plain scalar, folded over continuation lines indented past
        ``parent`` (any line inside a flow collection)."""
        self.refuse(pos)
        c = self.ch(pos)
        starts_ok = c not in _INDICATORS or (
            c in "-?:" and not self.spaced(pos + 1)
            and not (flow and self.ch(pos + 1) in _FLOW_END))
        if not starts_ok:
            self.fail(pos, f"a plain scalar cannot start with {c!r}")
        start = pos
        chunks: List[str] = []
        end = pos
        while True:
            line_end = self.eol(pos)
            q = pos
            while q < line_end:
                x = self.s[q]
                if x == ":" and (self.spaced(q + 1) or (
                        flow and self.ch(q + 1) in _FLOW_END)):
                    if flow:
                        break
                    self.fail(q, "mapping values are not allowed here")
                if x == "#" and self.s[q - 1] in _SPACE:
                    break
                if flow and x in _FLOW_END + "?":
                    break
                q += 1
            text = self.s[pos:q].rstrip(_SPACE)
            chunks.append(text)
            end = pos + len(text)
            if q < line_end:                # stopped on an indicator
                break
            # a continuation line: the next content, past blank lines,
            # indented past the parent (any indentation in a flow)
            nxt = line_end
            blank = 0
            while nxt < self.n:
                nxt = self.skip_inline(nxt + 1)
                if nxt < self.n and self.s[nxt] == "\n":
                    blank += 1
                    continue
                break
            if nxt >= self.n or self.marker(nxt) or self.s[nxt] == "#" \
                    or (flow and self.s[nxt] in _FLOW_END + ":?") \
                    or (not flow and self.col(nxt) <= parent):
                break
            chunks.append("\n" * blank if blank else " ")
            pos = nxt
        text = "".join(chunks)
        if _UNSUPPORTED.match(text):
            self.fail(start, f"{text!r} is not supported in a spec")
        return resolve(text), end

    def quoted_end(self, pos: int) -> int:
        quote = self.s[pos]
        q = pos + 1
        while q < self.n:
            if self.s[q] == quote:
                if quote == "'" and self.ch(q + 1) == "'":
                    q += 2
                    continue
                return q + 1
            if quote == '"' and self.s[q] == "\\":
                q += 2
                continue
            q += 1
        self.fail(pos, "unterminated quoted scalar")

    def quoted(self, pos: int, parent: int) -> Tuple[str, int]:
        """A single- or double-quoted scalar; line breaks inside fold as
        in a plain scalar (a break to a space, blank lines to breaks)."""
        quote = self.s[pos]
        end = self.quoted_end(pos)
        body = self.s[pos + 1:end - 1]
        out: List[str] = []
        i = 0
        while i < len(body):
            x = body[i]
            if x == "\n":
                # fold: trailing spaces before the break were dropped;
                # leading spaces of the next line are dropped
                while out and out[-1] in (" ", "\t"):
                    out.pop()
                j = i + 1
                breaks = 0
                while True:
                    while j < len(body) and body[j] in _SPACE:
                        j += 1
                    if j < len(body) and body[j] == "\n":
                        breaks += 1
                        j += 1
                        continue
                    break
                out.append("\n" * breaks if breaks else " ")
                i = j
                continue
            if quote == "'" and x == "'":
                out.append("'")
                i += 2
                continue
            if quote == '"' and x == "\\":
                e = body[i + 1] if i + 1 < len(body) else ""
                if e == "\n":        # escaped break: join without a space
                    j = i + 2
                    while j < len(body) and body[j] in _SPACE:
                        j += 1
                    i = j
                    continue
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                if e in _HEX_ESCAPES:
                    width = _HEX_ESCAPES[e]
                    digits = body[i + 2:i + 2 + width]
                    if len(digits) != width or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(pos, f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 2 + width
                    continue
                self.fail(pos, f"unknown escape \\{e}")
            out.append(x)
            i += 1
        return "".join(out), end

    def flow_end(self, pos: int) -> int:
        """Position just past the flow collection opening at ``pos``."""
        depth = 0
        q = pos
        while q < self.n:
            x = self.s[q]
            if x in "'\"":
                q = self.quoted_end(q)
                continue
            if x == "#" and self.s[q - 1] in _SPACE + _BREAKS:
                q = self.eol(q)
                continue
            if x in "[{":
                depth += 1
            elif x in "]}":
                depth -= 1
                if depth == 0:
                    return q + 1
            q += 1
        self.fail(pos, "unterminated flow collection")

    def flow(self, pos: int) -> Tuple[Any, int]:
        opening = self.s[pos]
        closing = "]" if opening == "[" else "}"
        out: Any = [] if opening == "[" else {}
        q = self.skip(pos + 1)
        while True:
            if q >= self.n:
                self.fail(pos, "unterminated flow collection")
            if self.s[q] == closing:
                return out, q + 1
            self.refuse(q)
            if opening == "[":
                item, q = self.flow_item(q)
                q = self.skip(q)
                if self.ch(q) == ":" and (self.spaced(q + 1)
                                          or self.ch(q + 1) in _FLOW_END):
                    self.fail(q, "single-pair mappings in a flow sequence "
                                 "are not supported in a spec")
                out.append(item)
            else:
                kpos = q
                if self.s[q] in "[{":
                    self.fail(q, "complex keys are not supported in a spec")
                key, q = self.flow_item(q)
                self.hashable(key, kpos)
                q = self.skip(q)
                value = None
                if self.ch(q) == ":":
                    q = self.skip(q + 1)
                    if self.ch(q) not in ",}":
                        self.refuse(q)
                        value, q = self.flow_item(q)
                        q = self.skip(q)
                out[key] = value
            if self.ch(q) == ",":
                q = self.skip(q + 1)
            elif self.ch(q) != closing:
                self.fail(q, f"expected ',' or {closing!r} in a flow "
                             "collection")

    def flow_item(self, pos: int) -> Tuple[Any, int]:
        c = self.ch(pos)
        if c in "[{":
            return self.flow(pos)
        if c in "'\"":
            return self.quoted(pos, -1)
        if c in ",]}":
            self.fail(pos, f"expected a value before {c!r}")
        return self.plain(pos, -1, flow=True)


def load(text: str, path: str = "<spec>") -> Tuple[Any, Dict[str, int]]:
    """Parse ``text``; returns ``(value, key_lines)``.

    ``value`` is what ``yaml.safe_load(text)`` returns; ``key_lines``
    maps each top-level mapping key (as a string) to its 1-based line,
    what the reference's ``plot._key_lines`` reads from
    ``yaml.compose``.  Raises :class:`SpecError` with ``path`` and the
    offending line on anything outside the subset.
    """
    reader = _Reader(text, path)
    value = reader.document()
    return value, reader.key_lines


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def _float_text(v: float) -> str:
    if v != v:
        return ".nan"
    if v == math.inf:
        return ".inf"
    if v == -math.inf:
        return "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _plain_ok(s: str) -> bool:
    """Whether ``s`` reads back as itself written plain in block
    context (PyYAML's ``analyze_scalar`` rules, block style)."""
    if not s or s != s.strip(" ") or s.startswith(("---", "...")):
        return False
    if any(not (" " <= c <= "~") for c in s):
        return False
    if s[0] in "#,[]{}&*!|>'\"%@`":
        return False
    if s[0] in "-?:" and (len(s) == 1 or s[1] == " "):
        return False
    if ": " in s or " #" in s or s.endswith(":"):
        return False
    return isinstance(resolve(s), str) and not _UNSUPPORTED.match(s)


#: Character → escape letter for the double-quoted scalars :func:`dump`
#: writes.
_ESCAPE_LETTERS = {v: k for k, v in _ESCAPES.items() if k not in "\t /"}


def _double_quoted(s: str) -> str:
    out = ['"']
    for c in s:
        if c in _ESCAPE_LETTERS:
            out.append("\\" + _ESCAPE_LETTERS[c])
        elif " " <= c <= "~":
            out.append(c)
        elif ord(c) <= 0xFF:
            out.append(f"\\x{ord(c):02X}")
        elif ord(c) <= 0xFFFF:
            out.append(f"\\u{ord(c):04X}")
        else:
            out.append(f"\\U{ord(c):08X}")
    out.append('"')
    return "".join(out)


def scalar_text(v: Any) -> str:
    """One scalar as ``yaml.safe_dump`` would write it."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if isinstance(v, str):
        if _plain_ok(v):
            return v
        if all(" " <= c <= "~" for c in v):
            return "'" + v.replace("'", "''") + "'"
        return _double_quoted(v)
    raise TypeError(f"cannot write a {type(v).__name__} in a spec")


def _is_collection(v: Any) -> bool:
    return isinstance(v, (dict, list, tuple))


def _write(v: Any, indent: int, lines: List[str], prefix: str) -> None:
    """Append ``v`` in block style; ``prefix`` is the text already on
    the current line (``key:`` or ``- ``)."""
    pad = " " * indent
    if isinstance(v, dict) and v:
        first = True
        for k, item in v.items():
            head = (prefix if first else pad) + scalar_text(k) + ":"
            first = False
            if _is_collection(item) and item:
                lines.append(head)
                if isinstance(item, dict):
                    _write(item, indent + 2, lines, " " * (indent + 2))
                else:
                    _write(item, indent, lines, pad)
            else:
                lines.append(head + " " + _inline(item))
        return
    if isinstance(v, (list, tuple)) and v:
        first = True
        for item in v:
            head = (prefix if first else pad) + "- "
            first = False
            if _is_collection(item) and item:
                _write(item, indent + 2, lines, head)
            else:
                lines.append(head + _inline(item))
        return
    lines.append(prefix + _inline(v))


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return scalar_text(v)


def dump(obj: Any) -> str:
    """``obj`` in block style with keys in insertion order, as
    ``yaml.safe_dump(obj, sort_keys=False)`` writes it (long scalars are
    not folded)."""
    if not _is_collection(obj):
        return _inline(obj) + "\n...\n"
    if not obj:
        return _inline(obj) + "\n"
    lines: List[str] = []
    _write(obj, 0, lines, "")
    return "\n".join(lines) + "\n"
