"""YAML config loading with left-to-right merging.

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


def load_config(paths: Iterable[str]) -> dict:
    return merge_configs(*[load_yaml(p) for p in paths])
