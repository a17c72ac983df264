"""Self-contained YAML config engine (a copy of `efg_tpu/config/config.py`).

- recursive ``includes:`` merging (include first, the including file wins),
  the paths followed as the YAML writes them;
- ``${oc.env:VAR}`` / ``${oc.env:VAR,default}`` (and ``env``) resolvers and
  ``${device_count:}``, the number of CUDA devices;
- interpolation ``${dataset.pc_range}`` (a whole-string match keeps the type);
- CLI dotlist overrides (``a.b.c value`` pairs or ``a.b=value``) with
  ``literal_eval`` decoding and ``key[idx]`` list indexing.

`default.yaml` beside this file is a copy of efg_tpu's.
"""

from __future__ import annotations

import ast
import copy
import os
import re
from typing import Any, Dict, List, Optional

import yaml

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class Config(dict):
    """A dict with attribute access, recursive wrapping, and deep-copy semantics.

    Missing attribute access raises AttributeError (unlike addict) so typos fail
    loudly. `.get(key, default)` is available for optional keys.
    """

    def __init__(self, data: Optional[dict] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = _wrap(v)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(f"Config has no key '{key}'. Available: {sorted(self.keys())}")

    def __setattr__(self, key, value):
        self[key] = value

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        return _unwrap(self)


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def merge_dict(base: Any, override: Any) -> Any:
    """Deep-merge `override` into `base` (override wins); returns a new object."""
    if isinstance(base, dict) and isinstance(override, dict):
        out = dict(base)
        for k, v in override.items():
            out[k] = merge_dict(base[k], v) if k in base else copy.deepcopy(v)
        return out
    return copy.deepcopy(override)


# ---------------------------------------------------------------------------
# Resolvers
# ---------------------------------------------------------------------------

def _resolve_env(expr: str) -> str:
    # expr after 'oc.env:' — 'VAR' or 'VAR,default'
    if "," in expr:
        var, default = expr.split(",", 1)
        return os.environ.get(var.strip(), default.strip())
    val = os.environ.get(expr.strip())
    if val is None:
        raise KeyError(f"Environment variable '{expr}' referenced in config is not set")
    return val


def _resolve_device_count(_: str) -> int:
    """The devices of the run on this machine: its local ranks (one in a
    world of one process), as efg_tpu's `jax.local_device_count()` reads
    the local devices of its process."""
    from efg_tpu_torch.utils import distributed as comm

    return comm.get_local_size()


_RESOLVERS = {
    "oc.env": _resolve_env,
    "env": _resolve_env,
    "device_count": _resolve_device_count,
}


def _lookup(root: Any, dotted: str) -> Any:
    cur = root
    for part in dotted.split("."):
        if isinstance(cur, dict):
            if part not in cur:
                raise KeyError(f"Interpolation '${{{dotted}}}' failed: no key '{part}'")
            cur = cur[part]
        elif isinstance(cur, list):
            cur = cur[int(part)]
        else:
            raise KeyError(f"Interpolation '${{{dotted}}}' failed at '{part}'")
    return cur


def _resolve_expr(expr: str, root: Any) -> Any:
    expr = expr.strip()
    if ":" in expr:
        name, arg = expr.split(":", 1)
        if name in _RESOLVERS:
            return _RESOLVERS[name](arg)
    return _lookup(root, expr)


def resolve_interpolations(node: Any, root: Any = None, _depth: int = 0) -> Any:
    """Resolve ``${...}`` interpolations. Whole-string matches preserve type."""
    if root is None:
        root = node
    if _depth > 20:
        raise RecursionError("Config interpolation depth exceeded (cycle?)")
    if isinstance(node, dict):
        for k in list(node.keys()):
            node[k] = resolve_interpolations(node[k], root, _depth)
        return node
    if isinstance(node, list):
        return [resolve_interpolations(v, root, _depth) for v in node]
    if isinstance(node, str):
        m = _INTERP_RE.fullmatch(node.strip())
        if m:
            val = _resolve_expr(m.group(1), root)
            return resolve_interpolations(val, root, _depth + 1) if isinstance(val, (str, dict, list)) else val

        def sub(match: "re.Match[str]") -> str:
            val = _resolve_expr(match.group(1), root)
            if isinstance(val, str):
                val = resolve_interpolations(val, root, _depth + 1)
            return str(val)

        if _INTERP_RE.search(node):
            return sub_all(node, sub)
        return node
    return node


def sub_all(text: str, repl) -> str:
    # substitute repeatedly in case resolution introduces new text (bounded)
    for _ in range(10):
        new = _INTERP_RE.sub(repl, text)
        if new == text:
            return new
        text = new
    return text


# ---------------------------------------------------------------------------
# Loading with includes
# ---------------------------------------------------------------------------

def _expand_path(path: str, base_dir: str) -> str:
    # include paths may use ${oc.env:...}
    path = _INTERP_RE.sub(lambda m: str(_resolve_expr(m.group(1), {})), path)
    if not os.path.isabs(path):
        path = os.path.join(base_dir, path)
    return os.path.normpath(path)


def load_yaml(path: str) -> dict:
    """Load a YAML file, recursively merging its ``includes:`` (include first,
    current file overrides; the includes key is removed)."""
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    base_dir = os.path.dirname(os.path.abspath(path))
    merged: dict = {}
    for inc in data.pop("includes", []) or []:
        inc_path = _expand_path(inc, base_dir)
        merged = merge_dict(merged, load_yaml(inc_path))
    return merge_dict(merged, data)


# ---------------------------------------------------------------------------
# Dotlist overrides
# ---------------------------------------------------------------------------

def _decode_value(text: str) -> Any:
    # YAML scalar words first (omegaconf semantics): null/true/false/...
    low = text.strip().lower()
    if low in ("null", "none", "~", ""):
        return None
    if low in ("true", "false"):
        return low == "true"
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        pass
    # bare-word containers like `[data,model]` (omegaconf-style overrides)
    if text[:1] in "[{":
        try:
            return yaml.safe_load(text)
        except yaml.YAMLError:
            pass
    return text


_IDX_RE = re.compile(r"^(.*)\[(\d+)\]$")


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    cur: Any = cfg
    for part in parts[:-1]:
        m = _IDX_RE.match(part)
        if m:
            cur = cur.setdefault(m.group(1), [])
            cur = cur[int(m.group(2))]
        else:
            if not isinstance(cur, dict):
                raise KeyError(f"Cannot descend into non-dict at '{part}' of '{dotted}'")
            if part not in cur or not isinstance(cur[part], (dict, list)):
                cur[part] = {}
            cur = cur[part]
    last = parts[-1]
    m = _IDX_RE.match(last)
    if m:
        lst = cur[m.group(1)]
        lst[int(m.group(2))] = value
    else:
        cur[last] = value


def apply_overrides(cfg: dict, opts: List[str]) -> dict:
    """Apply CLI overrides: either ``a.b=value`` tokens or ``a.b.c value`` pairs."""
    i = 0
    while i < len(opts):
        tok = opts[i]
        if "=" in tok:
            key, val = tok.split("=", 1)
            _set_dotted(cfg, key, _decode_value(val))
            i += 1
        else:
            if i + 1 >= len(opts):
                raise ValueError(f"Dangling config override key '{tok}' (no value)")
            _set_dotted(cfg, tok, _decode_value(opts[i + 1]))
            i += 2
    return cfg


# ---------------------------------------------------------------------------
# Configuration entry point
# ---------------------------------------------------------------------------

_DEFAULT_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "default.yaml")


class Configuration:
    """Build the final config: default.yaml ← user config ← CLI dotlist.

    `args` needs `.config` (path) and optionally `.opts` (list of override
    tokens)."""

    def __init__(self, args: Any = None, config_file: Optional[str] = None, opts: Optional[List[str]] = None):
        config_file = config_file or (getattr(args, "config", None) if args is not None else None)
        opts = opts if opts is not None else (list(getattr(args, "opts", []) or []) if args is not None else [])
        cfg = load_yaml(_DEFAULT_YAML)
        if config_file:
            cfg = merge_dict(cfg, load_yaml(config_file))
        apply_overrides(cfg, opts)
        resolve_interpolations(cfg)
        self._config = Config(cfg)

    def get_config(self) -> Config:
        return self._config
