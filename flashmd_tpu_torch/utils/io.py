"""Host-side YAML, logging and the progress bar (port of
flashmd_tpu/utils/io.py).

The card has no PyYAML, so ``load_yaml`` / ``dump_yaml`` carry their own
reader and writer for the subset that the simulation configs use (see
:func:`parse_yaml`). ``tqdm`` is imported when a bar is made, not when this
module is: where it is not installed the bar is the reference's no-op
fallback (flashmd_tpu/utils/io.py:17-19).
"""

from __future__ import annotations

import logging
import logging.handlers
import math
import re
import sys
from typing import Any, List, Tuple

logger = logging.getLogger("flashmd_tpu_torch")

#: File-sink rotation of the reference's logging setup: 100 MB a file,
#: 7 rotated generations.
LOG_ROTATE_BYTES = 100 * 1024 * 1024
LOG_BACKUP_COUNT = 7

_FORMAT = "%(asctime)s | %(levelname)s | %(name)s - %(message)s"


class _NoBar:
    """What ``tqdm`` returns where it is not installed."""

    def __init__(self, *args, **kwargs):
        pass

    def update(self, n=1):
        pass

    def close(self):
        pass


def tqdm(*args, **kwargs):
    """A ``tqdm`` progress bar, or a no-op one without ``tqdm``."""
    try:
        from tqdm import tqdm as bar
    except ImportError:
        bar = _NoBar
    return bar(*args, **kwargs)


def setup_logging(
    level: int = logging.INFO,
    log_file: str | None = None,
    rotate_bytes: int = LOG_ROTATE_BYTES,
    backup_count: int = LOG_BACKUP_COUNT,
) -> logging.Logger:
    """Console (and, with ``log_file``, rotating file) logging in the
    reference's format; idempotent per handler."""
    logger.setLevel(level)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    if log_file is not None and not any(
        isinstance(h, logging.FileHandler)
        and getattr(h, "baseFilename", None) == log_file
        for h in logger.handlers
    ):
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=rotate_bytes, backupCount=backup_count
        )
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger


def close_log_file(log_file: str) -> None:
    """Detach and close the file handler of ``log_file``, so that a later
    simulation in the process does not write into it."""
    for h in list(logger.handlers):
        if getattr(h, "baseFilename", None) == log_file:
            logger.removeHandler(h)
            h.close()


# ---------------------------------------------------------------------------
# YAML: the subset of the simulation configs, read as ``yaml.safe_load``
# reads it and written as ``yaml.safe_dump(default_flow_style=False,
# sort_keys=False)`` writes it
# ---------------------------------------------------------------------------

# The YAML 1.1 implicit types of a plain scalar, PyYAML's patterns: an
# exponent needs a sign and a float a dot, so ``1e-3`` stays a string.
_BOOL = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF")
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                      |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN)""", re.X)
_INT = re.compile(r"""[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_NULL = re.compile(r"~|null|Null|NULL|")
_TIMESTAMP = re.compile(
    r"""[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
      |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
       (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
       (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?""", re.X)

# double-quoted escapes, read and written
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_WRITE_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t",
                  "\n": "n", "\x0b": "v", "\x0c": "f", "\r": "r",
                  "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N",
                  "\xa0": "_", "\u2028": "L", "\u2029": "P"}
# what may not start a plain scalar, and what each start would be
_INDICATORS = {"&": "anchors", "*": "aliases", "!": "tags",
               "|": "block scalars", ">": "block scalars",
               "%": "directives", "@": "reserved indicators",
               "`": "reserved indicators"}


def _implicit_tag(text: str) -> str:
    """The type PyYAML's resolver gives a plain scalar."""
    for tag, pattern in (("null", _NULL), ("bool", _BOOL), ("int", _INT),
                         ("float", _FLOAT), ("timestamp", _TIMESTAMP)):
        if pattern.fullmatch(text):
            return tag
    if text in ("<<", "="):
        return "merge" if text == "<<" else "value"
    return "str"


def _base60(value: str, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _construct(text: str, tag: str):
    """PyYAML's SafeConstructor for the scalar types of the subset."""
    if tag == "null":
        return None
    if tag == "bool":
        return text.lower() in ("yes", "true", "on")
    value = text.replace("_", "")
    if tag == "float":
        value = value.lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if tag == "int":
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * (_base60(value, int) if ":" in value else int(value))
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    return sign * (_base60(value, float) if ":" in value else float(value))


def _mapping_indicator(text: str):
    """Index of the ``:`` that ends a plain key (followed by a blank or
    the end of the line, before any comment), or None."""
    for i, ch in enumerate(text):
        if ch == "#" and i > 0 and text[i - 1] in " \t":
            return None
        if ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            return i
    return None


def _is_item(body: str) -> bool:
    return body == "-" or body[:2] in ("- ", "-\t")


class _YamlReader:
    """One document of the subset, line by line (see :func:`parse_yaml`)."""

    def __init__(self, text: str, source: str):
        self.source = source
        self.lines: List[Tuple[int, int, str]] = []
        for no, raw in enumerate(text.lstrip("\ufeff").splitlines(), 1):
            body = raw.lstrip(" ")
            if not body.strip() or body.startswith("#"):
                continue
            if body[0] == "\t":
                raise self.error(no, "a tab in the indentation")
            if re.match(r"(?:---|\.\.\.)(?:[ \t]|$)", raw):
                raise self.error(no, "document markers (multi-document "
                                 "streams) are outside the subset")
            if raw.startswith("%"):
                raise self.error(no, "directives are outside the subset")
            self.lines.append((no, len(raw) - len(body), body.rstrip()))
        self.i = 0

    def error(self, no: int, msg: str) -> ValueError:
        return ValueError(f"{self.source}, line {no}: {msg}")

    def document(self):
        if not self.lines:
            return None
        no, indent, body = self.lines[0]
        if (_is_item(body) or body[0] in "'\""
                or _mapping_indicator(body) is not None):
            value = self.block(indent)
        else:
            value = self.inline(body, no)
            self.i = 1
        if self.i < len(self.lines):
            raise self.error(self.lines[self.i][0],
                             "unexpected indentation or a second node: "
                             "multi-line scalars and misplaced keys are "
                             "outside the subset")
        return value

    def block(self, indent: int):
        body = self.lines[self.i][2]
        return self.sequence(indent) if _is_item(body) else self.mapping(
            indent)

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            no, ind, body = self.lines[self.i]
            if ind < indent or (ind == indent and _is_item(body)):
                break
            if ind > indent:
                raise self.error(no, "unexpected indentation (multi-line "
                                 "scalars are outside the subset)")
            key, rest = self.key(body, no)
            self.i += 1
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if rest:
                out[key] = self.inline(rest, no)
            elif nxt is not None and nxt[1] > indent:
                out[key] = self.block(nxt[1])
            elif nxt is not None and nxt[1] == indent and _is_item(nxt[2]):
                out[key] = self.sequence(indent)
            else:
                out[key] = None
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            no, ind, body = self.lines[self.i]
            if ind != indent or not _is_item(body):
                break
            rest = body[1:].strip()
            if rest.startswith("#"):
                rest = ""
            self.i += 1
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if not rest and nxt is not None and nxt[1] > indent:
                raise self.error(no, "a block inside a sequence item is "
                                 "outside the subset")
            out.append(self.inline(rest, no) if rest else None)
        return out

    def key(self, body: str, no: int):
        """(key, the rest of the line) of a ``key: value`` line."""
        if body[0] in "'\"":
            key, end = self.quoted(body, 0, no)
            m = re.match(r"[ \t]*:(?:[ \t]+|$)", body[end:])
            if m is None:
                raise self.error(no, "expected ': ' after the quoted key")
            rest = body[end + m.end():]
        else:
            self.check_plain_start(body, no, "key")
            pos = _mapping_indicator(body)
            if pos is None:
                raise self.error(no, "expected 'key: value' (multi-line "
                                 "scalars are outside the subset)")
            key = self.plain(body[:pos].rstrip(), no)
            rest = body[pos + 1:]
        rest = rest.strip()
        return key, ("" if rest.startswith("#") else rest)

    def check_plain_start(self, text: str, no: int, what: str):
        c = text[0]
        if c in _INDICATORS:
            raise self.error(no, f"{_INDICATORS[c]} ({c!r}) are outside "
                             "the subset")
        if c in "[]{},#":
            raise self.error(no, f"a flow collection as a {what} is "
                             "outside the subset")
        if c in "?:-" and (len(text) == 1 or text[1] in " \t"):
            raise self.error(no, f"{c!r} starting a {what}: complex keys "
                             "and nested sequences are outside the subset")

    def plain(self, text: str, no: int):
        tag = _implicit_tag(text)
        if tag in ("timestamp", "merge", "value"):
            raise self.error(no, f"{text!r} resolves to a YAML {tag}, "
                             "outside the subset")
        return text if tag == "str" else _construct(text, tag)

    def inline(self, rest: str, no: int):
        """A value on its line: a scalar or a flow sequence of scalars."""
        c = rest[0]
        if c == "[":
            value, end = self.flow_sequence(rest, no)
        elif c == "{":
            m = re.match(r"\{[ \t]*\}", rest)
            if m is None:
                raise self.error(no, "flow mappings are outside the subset")
            value, end = {}, m.end()
        elif c in "'\"":
            value, end = self.quoted(rest, 0, no)
        else:
            self.check_plain_start(rest, no, "value")
            text = rest
            m = re.search(r"[ \t]#", text)
            if m is not None:
                text = text[:m.start()]
            text = text.rstrip()
            if _mapping_indicator(text) is not None:
                raise self.error(no, "a mapping inside a value or a "
                                 "sequence item is outside the subset")
            return self.plain(text, no)
        tail = rest[end:]
        if tail.strip() and not re.match(r"[ \t]+#", tail):
            raise self.error(no, f"unexpected text after the value: "
                             f"{tail.strip()!r}")
        return value

    def flow_sequence(self, text: str, no: int):
        out, i = [], 1
        while True:
            while i < len(text) and text[i] in " \t":
                i += 1
            if i == len(text):
                raise self.error(no, "unterminated flow sequence (multi-line "
                                 "flow collections are outside the subset)")
            if text[i] == "]":
                return out, i + 1
            if text[i] in "'\"":
                value, i = self.quoted(text, i, no)
            else:
                if text[i] in "[{":
                    raise self.error(no, "nested flow collections are "
                                     "outside the subset")
                j = i
                while j < len(text) and text[j] not in ",[]{}":
                    if text[j] == ":" and (j + 1 == len(text)
                                           or text[j + 1] in " \t,[]{}"):
                        raise self.error(no, "a mapping inside a flow "
                                         "sequence is outside the subset")
                    if text[j] == "#" and text[j - 1] in " \t":
                        raise self.error(no, "unterminated flow sequence")
                    j += 1
                item = text[i:j].rstrip()
                if not item:
                    raise self.error(no, "an empty flow sequence entry")
                self.check_plain_start(item, no, "flow sequence entry")
                value, i = self.plain(item, no), j
            out.append(value)
            while i < len(text) and text[i] in " \t":
                i += 1
            if i < len(text) and text[i] == ",":
                i += 1
            elif i < len(text) and text[i] == "]":
                return out, i + 1
            else:
                raise self.error(no, "expected ',' or ']' in a flow "
                                 "sequence")

    def quoted(self, text: str, start: int, no: int):
        """A quoted scalar on one line -> (value, index after it)."""
        out, i = [], start + 1
        if text[start] == "'":
            while True:
                j = text.find("'", i)
                if j < 0:
                    break
                out.append(text[i:j])
                if text[j + 1:j + 2] != "'":
                    return "".join(out), j + 1
                out.append("'")
                i = j + 2
        else:
            while i < len(text):
                ch = text[i]
                if ch == '"':
                    return "".join(out), i + 1
                i += 1
                if ch != "\\":
                    out.append(ch)
                    continue
                esc = text[i:i + 1]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    i += 1
                elif esc in _HEX_ESCAPES:
                    digits = text[i + 1:i + 1 + _HEX_ESCAPES[esc]]
                    if not re.fullmatch(f"[0-9a-fA-F]{{{_HEX_ESCAPES[esc]}}}",
                                        digits):
                        raise self.error(no, f"bad escape \\{esc}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 1 + len(digits)
                else:
                    break
        raise self.error(no, "unterminated quoted scalar or a line "
                         "continuation (multi-line scalars are outside the "
                         "subset)")


def parse_yaml(text: str, source: str = "<yaml>"):
    """``yaml.safe_load`` of one document in the configs' subset.

    The subset: ``#`` comments; block mappings nested by indentation; block
    sequences of scalars (``- 1.67``); flow sequences of scalars
    (``[1.67, 1.42]``), and ``{}`` / ``[]``; plain, single- and
    double-quoted scalars on one line, plain ones resolved as PyYAML's
    YAML 1.1 resolver does (``yes`` is True, ``1.0e-3`` a float, ``1e-3``
    the string '1e-3', ``0x1f`` 31). Anything else (anchors, aliases, tags,
    block scalars, flow mappings, multi-line scalars, timestamps, several
    documents) raises ValueError naming the line."""
    return _YamlReader(text, source).document()


def _plain_allowed(text: str) -> bool:
    """Whether PyYAML's emitter writes ``text`` as a plain block scalar."""
    return (bool(text) and text[0] != " " and text[-1] != " "
            and all(" " <= ch <= "~" for ch in text)
            and not text.startswith(("---", "..."))
            and text[0] not in "#,[]{}&*!|>'\"%@`"
            and not (text[0] in "?:-" and text[1:2] in ("", " "))
            and ": " not in text and not text.endswith(":")
            and " #" not in text and _implicit_tag(text) == "str")


def _scalar_text(value) -> str:
    """A scalar as ``yaml.safe_dump`` writes it."""
    if value is None:
        return "null"
    if type(value) is bool:
        return "true" if value else "false"
    if type(value) is int:
        return str(value)
    if type(value) is float:
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if type(value) is str:
        if _plain_allowed(value):
            return value
        if all(" " <= ch <= "~" for ch in value):
            return "'" + value.replace("'", "''") + "'"
        return '"' + "".join(_escape(ch) for ch in value) + '"'
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")


def _escape(ch: str) -> str:
    if ch in _WRITE_ESCAPES:
        return "\\" + _WRITE_ESCAPES[ch]
    if " " <= ch <= "~":
        return ch
    code = ord(ch)
    if code <= 0xFF:
        return f"\\x{code:02X}"
    return f"\\u{code:04X}" if code <= 0xFFFF else f"\\U{code:08X}"


def _format_mapping(data: dict, indent: int, out: List[str]):
    pad = " " * indent
    for key, value in data.items():
        if key == "":
            raise ValueError("an empty key (written as a complex '? ' key) "
                             "is outside the subset")
        head = f"{pad}{_scalar_text(key)}:"
        if type(value) is dict and value:
            out.append(head)
            _format_mapping(value, indent + 2, out)
        elif type(value) is list and value:
            out.append(head)
            for item in value:
                if type(item) in (dict, list):
                    raise ValueError("a collection inside a sequence is "
                                     "outside the subset")
                out.append(f"{pad}- {_scalar_text(item)}")
        elif type(value) in (dict, list):
            out.append(f"{head} {'{}' if type(value) is dict else '[]'}")
        else:
            out.append(f"{head} {_scalar_text(value)}")


def format_yaml(data: dict) -> str:
    """A mapping as ``yaml.safe_dump(data, default_flow_style=False,
    sort_keys=False)`` writes it (long scalars are not folded; a string
    with a line break or a character outside printable ASCII is written
    double-quoted). Values: dicts, lists of scalars, str, int, float,
    bool, None."""
    if type(data) is not dict:
        raise TypeError(f"dump_yaml writes a mapping, got {type(data)}")
    if not data:
        return "{}\n"
    out: List[str] = []
    _format_mapping(data, 0, out)
    return "\n".join(out) + "\n"


def load_yaml(fn) -> Any:
    """Read a YAML file of the configs' subset (:func:`parse_yaml`)."""
    with open(fn, "r") as f:
        return parse_yaml(f.read(), source=str(fn))


def dump_yaml(fn, data: dict):
    """Write ``data`` as :func:`format_yaml` formats it."""
    with open(fn, "w") as f:
        f.write(format_yaml(data))
