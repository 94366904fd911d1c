"""Hydra-style configuration: YAML files + dotted CLI overrides
(counterpart of ``climsim_tpu/train/config.py``).

``load_config("conf/x.yaml", ["optimizer.lr=3e-4", "model.nh_mem=32"])``
returns a dot-accessible nested config, as the JAX package's does, but
without PyYAML: this module reads the subset of YAML that ``conf/*.yaml``
is written in, and nothing else:

* block mappings, nested by indentation (spaces only);
* single-line flow sequences of scalars (``[192, 192]``) and flow
  mappings of scalars (``{0: 1, 3: 2, 6: 3}``);
* plain scalars, resolved by the YAML 1.2 core schema: ``null``/``~``/
  empty, ``true``/``false``, ints (decimal, ``0o``, ``0x``), floats
  (``3.0e7``, ``.5``, ``.inf``, ``.nan``) and otherwise strings;
* full-line and trailing comments (`` #`` after a space).

A line outside that subset (quotes, anchors, tags, block sequences,
block scalars, document markers, tabs, a duplicate key) raises
``ValueError`` naming its line; nothing falls back.

The one departure from the JAX package: PyYAML follows YAML 1.1, under
which a float's exponent needs a sign, so it reads ``3.0e7`` as the
string ``'3.0e7'``; here it is the float 3e7, as YAML 1.2 reads it.
``conf/autoreg_physrnn.yaml`` and ``conf/autoreg_longwindows.yaml`` write
``w_wcon: 3.0e7``; the JAX CLI then fails at its first update comparing
that string with 0.
"""
from __future__ import annotations

import ast
import math
import re
from typing import Any

_NULL = ("null", "Null", "NULL", "~", "")
_TRUE = ("true", "True", "TRUE")
_FALSE = ("false", "False", "FALSE")
_INT = re.compile(r"[-+]?[0-9]+")
_OCT = re.compile(r"0o[0-7]+")
_HEX = re.compile(r"0x[0-9a-fA-F]+")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)")
_NAN = re.compile(r"\.(nan|NaN|NAN)")
# characters that start a YAML construct outside the subset
_SPECIAL_START = tuple("'\"&*!|>%@`?")
_KEY = re.compile(r"([^\s:#\[\]{},][^:#\[\]{},]*?)\s*:(?:\s+|$)(.*)$")


class Config(dict):
    """dict with attribute access and recursive wrapping."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) \
            else v

    def __setattr__(self, k, v):
        self[k] = v

    def to_dict(self) -> dict:
        def conv(v):
            return {k: conv(x) for k, x in v.items()} if isinstance(v, dict) \
                else v
        return conv(self)


def _parse_value(s: str) -> Any:
    """An override's value, as the JAX package parses it: true/false,
    null/none, a Python literal, else the string."""
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def resolve_scalar(s: str) -> Any:
    """A plain scalar by the YAML 1.2 core schema."""
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.fullmatch(s):
        return int(s)
    if _OCT.fullmatch(s):
        return int(s[2:], 8)
    if _HEX.fullmatch(s):
        return int(s[2:], 16)
    if _FLOAT.fullmatch(s):
        return float(s)
    if _INF.fullmatch(s):
        return -math.inf if s[0] == "-" else math.inf
    if _NAN.fullmatch(s):
        return math.nan
    return s


def _strip_comment(line: str) -> str:
    """The line without its comment: '#' at the start or after
    whitespace begins one."""
    for i, ch in enumerate(line):
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, lineno: int) -> Any:
    text = text.strip()
    if text.startswith(_SPECIAL_START) or text.startswith("- ") \
            or text == "-" or any(c in text for c in "[]{}"):
        raise ValueError(f"line {lineno}: {text!r} is outside the YAML "
                         f"subset this reader takes")
    return resolve_scalar(text)


def _flow(text: str, lineno: int) -> Any:
    """A one-line flow sequence or mapping of scalars."""
    inner = text[1:-1].strip()
    items = [] if not inner else [p.strip() for p in inner.split(",")]
    if items and items[-1] == "":
        items.pop()                 # a trailing comma
    if text[0] == "[":
        return [_scalar(p, lineno) for p in items]
    out = {}
    for p in items:
        if ":" not in p:
            raise ValueError(f"line {lineno}: flow mapping entry {p!r} "
                             f"has no ':'")
        k, v = p.split(":", 1)
        key = _scalar(k, lineno)
        if key in out:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        out[key] = _scalar(v, lineno)
    return out


def _value(text: str, lineno: int) -> Any:
    text = text.strip()
    if text[:1] in "[{":
        if text[-1:] != {"[": "]", "{": "}"}[text[0]]:
            raise ValueError(f"line {lineno}: a flow collection must close "
                             f"on its own line")
        return _flow(text, lineno)
    return _scalar(text, lineno)


def parse_yaml(text: str) -> dict:
    """The mapping a document of the subset (module docstring) holds;
    an empty document gives {}."""
    root: dict = {}
    # stack of (indent of the mapping's keys, the mapping)
    stack: list[tuple[int, dict]] = [(0, root)]
    pending = None          # (dict, key, indent): a key without a value
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {lineno}: tab in indentation")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.startswith(("---", "...")) or line.lstrip().startswith("- ") \
                or line.strip() == "-":
            raise ValueError(f"line {lineno}: {line.strip()!r} is outside "
                             f"the YAML subset this reader takes")
        indent = len(line) - len(line.lstrip(" "))
        if pending is not None:
            parent, key, pind = pending
            pending = None
            if indent > pind:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise ValueError(f"line {lineno}: indentation does not match "
                             f"any open mapping")
        m = _KEY.fullmatch(line.strip())
        if m is None:
            raise ValueError(f"line {lineno}: {line.strip()!r} is not a "
                             f"'key: value' line")
        mapping = stack[-1][1]
        key = _scalar(m.group(1), lineno)
        if key in mapping:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        rest = m.group(2).strip()
        if rest:
            mapping[key] = _value(rest, lineno)
        else:
            mapping[key] = None
            pending = (mapping, key, indent)
    return root


def _dump_scalar(v: Any) -> str:
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
        # with a dot before any exponent, which Python's repr writes with
        # a sign: YAML 1.1 readers then take it as a float as well
        r = repr(v)
        return r if "." in r or "e" not in r else r.replace("e", ".0e")
    if isinstance(v, str):
        if v == "" or resolve_scalar(v) != v or v.strip() != v \
                or v.startswith(_SPECIAL_START + ("-",)) \
                or any(c in v for c in ":#[]{},\n\t"):
            raise ValueError(f"the string {v!r} cannot be written as a plain "
                             f"scalar")
        return v
    raise ValueError(f"{type(v).__name__} {v!r} is outside the YAML subset")


def dump_yaml(d: dict, indent: int = 0) -> str:
    """Write ``d`` in the subset: string-keyed mappings as blocks, other
    mappings and lists as flow collections of scalars."""
    lines = []
    pad = " " * indent
    for k, v in d.items():
        key = _dump_scalar(k)
        if isinstance(v, dict) and v and all(isinstance(x, str) for x in v):
            lines.append(f"{pad}{key}:")
            lines.append(dump_yaml(v, indent + 2).rstrip("\n"))
        elif isinstance(v, dict):
            body = ", ".join(f"{_dump_scalar(a)}: {_dump_scalar(b)}"
                             for a, b in v.items())
            lines.append(f"{pad}{key}: {{{body}}}")
        elif isinstance(v, (list, tuple)):
            body = ", ".join(_dump_scalar(x) for x in v)
            lines.append(f"{pad}{key}: [{body}]")
        else:
            lines.append(f"{pad}{key}: {_dump_scalar(v)}")
    return "\n".join(lines) + "\n"


def _set_dotted(cfg: dict, key: str, value: Any):
    parts = key.split(".")
    d = cfg
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def _merge(base: dict, over: dict):
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v


def load_config(path: str | None = None, overrides: list[str] | None = None,
                defaults: dict | None = None) -> Config:
    """Load a YAML file of the subset + apply `a.b=c` overrides (values
    literal-eval'd, as the JAX package does)."""
    cfg: dict = dict(defaults or {})
    if path:
        with open(path) as f:
            try:
                _merge(cfg, parse_yaml(f.read()))
            except ValueError as e:
                raise ValueError(f"{path}: {e}") from None
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not key=value")
        k, v = ov.split("=", 1)
        _set_dotted(cfg, k.strip(), _parse_value(v.strip()))
    return Config(cfg)


def save_config(cfg: Config, path: str):
    """Write ``cfg`` in the subset that :func:`load_config` reads back."""
    text = dump_yaml(cfg.to_dict() if isinstance(cfg, Config) else cfg)
    with open(path, "w") as f:
        f.write(text)
