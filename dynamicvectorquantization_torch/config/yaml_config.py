"""YAML config loading with left-to-right merging, `key.path=value` dotlist
overrides, and a writer for the same subset (the config snapshot a training
run leaves in its logdir and reads back on resume).

Counterpart of `dynamicvectorquantization_tpu/config/yaml_config.py`. The
port depends on torch, numpy and the standard library only, so instead of
PyYAML it parses the subset of YAML the repository's configs use: block
mappings by indentation, `#` comments, flow lists (`[1, 1, 2, 2]`), quoted
strings, and PyYAML's (YAML 1.1) scalar rules for null, booleans, ints and
floats. Anything outside that subset raises `ValueError`.
"""
from __future__ import annotations

import copy
import re
from typing import Any, Iterable, Mapping

_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
# YAML 1.1 (PyYAML) floats need a dot: "1.0e-05" is a float, "1e-5" a string
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_scalar(text: str):
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [parse_scalar(p) for p in inner.split(",")] if inner else []
    if t.startswith(("{", "[", "&", "*", "!", "|", ">")):
        raise ValueError(f"unsupported YAML construct: {t!r}")
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t in ("true", "True", "TRUE"):
        return True
    if t in ("false", "False", "FALSE"):
        return False
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t) and t not in (".", "-.", "+."):
        return float(t.replace("_", ""))
    return t


def parse_yaml(text: str) -> dict:
    """Parse the block-mapping YAML subset described in the module doc."""
    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping)
    pending = None  # (indent, parent, key) of a `key:` awaiting a block
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith("- ") or body == "-":
            raise ValueError(f"line {lineno}: block lists are not supported")
        if pending is not None:
            p_indent, parent, key = pending
            pending = None
            if indent > p_indent:
                child: dict = {}
                parent[key] = child
                stack.append((p_indent, child))
            else:
                parent[key] = None
        while stack[-1][0] >= indent:
            stack.pop()
        mapping = stack[-1][1]
        key, sep, rest = body.partition(":")
        if not sep or (rest and not rest.startswith((" ", "\t"))):
            raise ValueError(f"line {lineno}: expected `key: value`, got {body!r}")
        key = parse_scalar(key)
        if rest.strip():
            mapping[key] = parse_scalar(rest)
        else:
            pending = (indent, mapping, key)
    if pending is not None:
        pending[1][pending[2]] = None
    return root


def load_yaml(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return parse_yaml(f.read())


def merge_configs(*configs: Mapping[str, Any]) -> dict:
    """Deep-merge mappings left-to-right (later values win)."""
    out: dict = {}
    for cfg in configs:
        out = _deep_merge(out, cfg)
    return out


def _deep_merge(base: Mapping[str, Any], other: Mapping[str, Any]) -> dict:
    out = dict(base)
    for k, v in other.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def apply_dotlist(config: dict, dotlist: Iterable[str]) -> dict:
    """Apply `a.b.c=value` overrides (values parsed as YAML scalars)."""
    out = copy.deepcopy(config)
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"Dotlist override must look like key=value, got {item!r}")
        key, _, raw = item.partition("=")
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_scalar(raw)
    return out


def load_config(paths: Iterable[str], dotlist: Iterable[str] = ()) -> dict:
    cfg = merge_configs(*[load_yaml(p) for p in paths])
    if dotlist:
        cfg = apply_dotlist(cfg, dotlist)
    return cfg


def _dump_scalar(value, in_list=False) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        text = repr(value)
        if "inf" in text or "nan" in text:
            raise ValueError(f"cannot write {value!r} in the YAML subset")
        mantissa, e, exponent = text.partition("e")
        if "." not in mantissa:  # YAML 1.1 floats need a dot: 1e-05 would read as a string
            mantissa += ".0"
        return mantissa + e + exponent
    if isinstance(value, str):
        quote = "'" if '"' in value else '"'
        if quote in value or "\n" in value or (in_list and "," in value):
            raise ValueError(f"cannot write the string {value!r} in the YAML subset")
        return f"{quote}{value}{quote}"
    raise ValueError(f"cannot write a {type(value).__name__} in the YAML subset")


def dump_yaml(config: Mapping[str, Any], indent: int = 0) -> str:
    """Write a config in the subset `parse_yaml` reads, so that
    `parse_yaml(dump_yaml(c)) == c` (an empty mapping comes back as None)."""
    lines = []
    pad = " " * indent
    for key, value in config.items():
        name = _dump_scalar(key) if not isinstance(key, str) or parse_scalar(key) != key \
            or ":" in key or "#" in key else key
        if isinstance(value, Mapping):
            lines.append(f"{pad}{name}:")
            if value:
                lines.append(dump_yaml(value, indent + 2))
        elif isinstance(value, (list, tuple)):
            items = ", ".join(_dump_scalar(v, in_list=True) for v in value)
            lines.append(f"{pad}{name}: [{items}]")
        else:
            lines.append(f"{pad}{name}: {_dump_scalar(value)}")
    return "\n".join(lines)
