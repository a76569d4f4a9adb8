"""Config and flag system, argbind-compatible (counterpart of
`vampnet_tpu/config.py`).

The reference drives every script with `argbind`: YAML files with `$include`
composition, `Class.attr` keys, `scope/` prefixes for per-split overrides,
and CLI `--args.load conf.yml --Class.attr value` overrides:

    args = parse_args()                       # --args.load + --Key value
    cfg  = load_config("configs/lora/lora.yml")  # resolves $include chains
    with scope(args, "train"):                # train/AudioDataset.x wins
        val = bound(args, "AudioDataset", "duration")

The machine with the card has no `yaml`, so this module reads and writes the
YAML subset that the repo's configs and CLI values use, with PyYAML's
`safe_load` semantics (YAML 1.1 scalars): a top-level mapping of
`key: value`; comments; scalars (int, float, bool, null, plain and quoted
strings); flow lists `[a, b]` of scalars and block lists `- item` of scalars
or of such flow lists (fine_tune's `AudioLoader.sources`, a list of lists,
is written `- [a, b]`, which `yaml.safe_load` reads as PyYAML's `- - a`
layout). Anything else (nested mappings, anchors, tags, block scalars,
hex, octal and sexagesimal numbers, timestamps, multi-line scalars) raises
`ValueError` naming the line, rather than being guessed at.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

_ACTIVE_SCOPES: List[str] = []

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
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
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# plain scalars the writer leaves unquoted
_SAFE_PLAIN = re.compile(r"^[A-Za-z0-9_$./][A-Za-z0-9_$./+\-]*$")
_INDICATORS = "[]{},#&*!|>'\"%@`"
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t"}


class _Refused(ValueError):
    pass


def _strip_comment(line: str) -> str:
    """`line` without a `#` comment (a `#` at the start or after whitespace,
    outside quotes)."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote == '"' and ch == "\\":
            i += 2
            continue
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _resolve(s: str) -> Any:
    """A plain scalar as PyYAML's safe loader resolves it."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        if not _DECIMAL.match(s):
            raise _Refused(f"integer {s!r} (binary, octal, hex or sexagesimal)")
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        if ":" in s:
            raise _Refused(f"sexagesimal number {s!r}")
        low = s.replace("_", "").lower()
        if low.lstrip("+-") == ".inf":
            return -math.inf if low.startswith("-") else math.inf
        if low == ".nan":
            return math.nan
        return float(low)
    if _TIMESTAMP.match(s):
        raise _Refused(f"timestamp {s!r}")
    if s in ("=", "<<"):
        raise _Refused(f"{s!r} (a value or merge key)")
    return s


def _unquote(s: str) -> str:
    q = s[0]
    if len(s) < 2 or s[-1] != q:
        raise _Refused(f"unterminated or trailing text after a quoted scalar: {s}")
    body = s[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise _Refused(f"a lone quote inside {s}")
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch == '"':
            raise _Refused(f"a lone quote inside {s}")
        if ch == "\\":
            esc = body[i + 1: i + 2]
            if esc not in _ESCAPES:
                raise _Refused(f"escape \\{esc} in {s}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _scalar(s: str, flow: bool = False) -> Any:
    """A scalar: quoted, or plain and resolved."""
    s = s.strip()
    if s[:1] in "'\"":
        return _unquote(s)
    if s[:1] and s[0] in _INDICATORS or s[:2] in ("- ", "? ", ": ") or s in ("-", "?", ":"):
        raise _Refused(f"a scalar starting with an indicator: {s}")
    if ": " in s or s.endswith(":"):
        raise _Refused(f"a mapping inside a value: {s}")
    if flow and any(c in s for c in "[]{},"):
        raise _Refused(f"a flow indicator inside a list item: {s}")
    return _resolve(s)


def _split_flow(body: str) -> List[str]:
    items, cur, quote, i = [], [], None, 0
    while i < len(body):
        ch = body[i]
        if quote == '"' and ch == "\\":
            cur.append(body[i: i + 2])
            i += 2
            continue
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in "'\"" and not "".join(cur).strip():
            quote = ch
        elif ch == ",":
            items.append("".join(cur))
            cur = []
            i += 1
            continue
        cur.append(ch)
        i += 1
    items.append("".join(cur))
    if items and not items[-1].strip():  # `[]`, or a trailing comma
        items.pop()
    if any(not it.strip() for it in items):
        raise _Refused(f"an empty item in the flow list [{body}]")
    return items


def _value(s: str) -> Any:
    """A mapping value or a CLI value: a flow list or a scalar."""
    s = s.strip()
    if s.startswith("["):
        if not s.endswith("]") or "[" in s[1:-1] or "{" in s[1:-1]:
            raise _Refused(f"a flow list that is not a flat list of scalars: {s}")
        return [_scalar(it, flow=True) for it in _split_flow(s[1:-1])]
    return _scalar(s)


def _split_key(line: str):
    """'key: rest' -> (key, rest), the colon the first one outside quotes
    followed by a space or the end of the line."""
    quote = None
    for i, ch in enumerate(line):
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(line) or line[i + 1] == " "):
            return line[:i], line[i + 1:]
    return None


def loads(text: str) -> Dict[str, Any]:
    """The YAML subset (module docstring) -> a dict, as `yaml.safe_load`
    gives it (an empty document is {})."""
    data: Dict[str, Any] = {}
    list_key, list_indent = None, None
    for lineno, raw in enumerate(text.splitlines(), 1):
        try:
            line = _strip_comment(raw).rstrip()
            if not line.strip():
                continue
            lead = line[: len(line) - len(line.lstrip())]
            if "\t" in lead:
                raise _Refused("a tab in the indentation")
            indent, body = len(lead), line.strip()
            if body in ("---", "...") or body.startswith(("--- ", "%")):
                raise _Refused("document markers and directives")
            if body == "-" or body.startswith("- "):
                if list_key is None:
                    raise _Refused("a list item outside a key's block list")
                if list_indent is None:
                    list_indent = indent
                elif indent != list_indent:
                    raise _Refused("list items at different indentations")
                if data[list_key] is None:
                    data[list_key] = []
                data[list_key].append(None if body == "-" else _value(body[2:]))
                continue
            if indent != 0:
                raise _Refused("an indented line that is not a list item "
                               "(nested mappings and multi-line scalars)")
            parts = _split_key(body)
            if parts is None:
                raise _Refused("a line that is not `key: value`")
            key = _scalar(parts[0])
            if not isinstance(key, str):
                raise _Refused(f"a key that is not a string: {parts[0]!r}")
            rest = parts[1].strip()
            if rest:
                data[key] = _value(rest)
                list_key = None
            else:
                data[key] = None
                list_key, list_indent = key, None
        except _Refused as e:
            raise ValueError(f"line {lineno}: {e}: outside the YAML subset that "
                             f"vampnet_tpu_torch.config reads: {raw!r}") from None
    return data


def _dump_scalar(x: Any) -> str:
    if x is None:
        return "null"
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        if math.isnan(x):
            return ".nan"
        if math.isinf(x):
            return ".inf" if x > 0 else "-.inf"
        text = repr(x).lower()
        if "." not in text and "e" in text:  # 1e-05 -> 1.0e-05, as PyYAML writes it
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(x, str):
        if any(ord(c) < 32 for c in x):
            raise ValueError(f"cannot write a string with control characters: {x!r}")
        if _SAFE_PLAIN.match(x) and _resolve(x) == x:
            return x
        return "'" + x.replace("'", "''") + "'"
    raise ValueError(f"cannot write a {type(x).__name__} in the YAML subset: {x!r}")


def dumps(data: Dict[str, Any], sort_keys: bool = True) -> str:
    """A flat dict of scalars and lists of scalars -> YAML in block style, as
    `yaml.safe_dump(data, default_flow_style=False)` lays it out; a list's
    item that is a flat list is written as a flow list."""
    lines = []
    for key in (sorted(data) if sort_keys else data):
        val = data[key]
        k = _dump_scalar(str(key))
        if isinstance(val, (list, tuple)):
            if not val:
                lines.append(f"{k}: []")
                continue
            lines.append(f"{k}:")
            for item in val:
                if isinstance(item, (list, tuple)):  # a flat flow list
                    if any(isinstance(x, (list, tuple, dict)) for x in item):
                        raise ValueError(f"{key}: nested containers are outside the YAML "
                                         "subset")
                    lines.append("- [" + ", ".join(_dump_scalar(x) for x in item) + "]")
                elif isinstance(item, dict):
                    raise ValueError(f"{key}: nested containers are outside the YAML subset")
                else:
                    lines.append(f"- {_dump_scalar(item)}")
        else:
            lines.append(f"{k}: {_dump_scalar(val)}")
    return "\n".join(lines) + "\n" if lines else "{}\n"


def load_config(path) -> Dict[str, Any]:
    """Load a YAML config, resolving `$include` lists recursively. Later
    includes override earlier ones; the including file overrides includes
    (argbind semantics). An include path is tried as given, then beside the
    including file."""
    path = Path(path)
    data = loads(path.read_text())
    includes = data.pop("$include", None) or []
    merged: Dict[str, Any] = {}
    for inc in includes:
        inc_path = Path(inc)
        if not inc_path.exists():
            inc_path = path.parent / inc
        merged.update(load_config(inc_path))
    merged.update(data)
    return merged


def parse_args(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse `--args.load conf.yml` plus arbitrary `--Key value` overrides
    into a flat config dict (`--Key v1 v2` gives a list, a bare `--flag`
    True)."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--args.load", dest="load", default=None)
    parser.add_argument("--args.debug", dest="debug", default=None)
    known, rest = parser.parse_known_args(argv)
    args: Dict[str, Any] = {}
    if known.load:
        args.update(load_config(known.load))
    key = None
    for tok in rest:
        if tok.startswith("--"):
            if "=" in tok:
                k, v = tok[2:].split("=", 1)
                args[k] = _parse_value(v)
                key = None
            else:
                key = tok[2:]
                args[key] = True  # bare flag
        elif key is not None:
            prev = args.get(key)
            if prev is True:
                args[key] = _parse_value(tok)
            elif isinstance(prev, list):
                prev.append(_parse_value(tok))
            else:
                args[key] = [prev, _parse_value(tok)]
    return args


def _parse_value(v: str) -> Any:
    """A CLI value as `yaml.safe_load` reads it, within the subset."""
    text = _strip_comment(v).strip()
    if not text:
        return None
    try:
        return _value(text)
    except _Refused as e:
        raise ValueError(f"CLI value {v!r}: {e}: outside the YAML subset that "
                         f"vampnet_tpu_torch.config reads") from None


@contextlib.contextmanager
def scope(args: Dict[str, Any], name: str = ""):
    """Activate a scope: keys `name/Key` shadow `Key` inside the context
    (argbind.scope semantics)."""
    if name:
        _ACTIVE_SCOPES.append(name)
    try:
        yield args
    finally:
        if name:
            _ACTIVE_SCOPES.pop()


def bound(args: Dict[str, Any], prefix: str, attr: str, default: Any = None) -> Any:
    """Look up `prefix.attr`, honouring active scopes (innermost first)."""
    key = f"{prefix}.{attr}" if prefix else attr
    for s in reversed(_ACTIVE_SCOPES):
        scoped_key = f"{s}/{key}"
        if scoped_key in args:
            return args[scoped_key]
    return args.get(key, default)


def bind_kwargs(args: Dict[str, Any], prefix: str, **defaults) -> Dict[str, Any]:
    """Collect every `prefix.attr` key (scope-aware) over `defaults`: the
    argbind.bind(Class) call pattern."""
    out = dict(defaults)
    for k in sorted(args):
        base = k.split("/")[-1]
        if base.startswith(prefix + "."):
            attr = base[len(prefix) + 1:]
            if "/" in k:
                s = k.rsplit("/", 1)[0]
                if s not in _ACTIVE_SCOPES:
                    continue
            if "." in attr:
                continue
            out[attr] = bound(args, prefix, attr, out.get(attr))
    return out


def dump_args(args: Dict[str, Any], path) -> None:
    """Write the resolved args (upstream's train.py writes args.yml)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(dumps(args))


def generate_conf(path, include: List[str], overrides: Dict[str, Any]) -> None:
    """Write a derived conf (upstream's fine_tune.py conf generation)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = {"$include": list(include), **overrides} if include else dict(overrides)
    path.write_text(dumps(data, sort_keys=False))
