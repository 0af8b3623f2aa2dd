"""Config system: YAML + ``${var}`` interpolation + dotted overrides.

Counterpart of ``fastvim_tpu/config.py``: configs live in
``fastvim_tpu_torch/configs/<domain>/``, reference top-level keys with
``${key}``, and accept command-line overrides as ``key=value`` /
``nested.key=value``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Any, Dict, List, Optional

import yaml

CONFIG_ROOT = os.path.join(os.path.dirname(__file__), "configs")

_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _resolve(value: Any, root: Dict[str, Any]) -> Any:
    if isinstance(value, str):
        m = _INTERP.fullmatch(value)
        if m:
            return _lookup(root, m.group(1))
        return _INTERP.sub(
            lambda mm: str(_lookup(root, mm.group(1))), value)
    if isinstance(value, dict):
        return {k: _resolve(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve(v, root) for v in value]
    return value


def _lookup(cfg: Dict[str, Any], dotted: str) -> Any:
    node: Any = cfg
    for part in dotted.split("."):
        node = node[part]
    return node


def _set(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        if text.lower() in ("true", "false"):
            return text.lower() == "true"
        if text.lower() in ("null", "none"):
            return None
        return text


def load_config(name: str, domain: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> Dict[str, Any]:
    """Load ``configs/<domain>/<name>.yaml`` (or a filesystem path),
    apply overrides, resolve interpolations."""
    if os.path.isfile(name):
        path = name
    else:
        fname = name if name.endswith(".yaml") else name + ".yaml"
        candidates = ([os.path.join(CONFIG_ROOT, domain, fname)]
                      if domain else [])
        candidates += [os.path.join(CONFIG_ROOT, d, fname)
                       for d in sorted(os.listdir(CONFIG_ROOT))
                       if os.path.isdir(os.path.join(CONFIG_ROOT, d))]
        candidates.append(os.path.join(CONFIG_ROOT, fname))
        path = next((c for c in candidates if os.path.isfile(c)), None)
        if path is None:
            raise FileNotFoundError(
                f"config {name!r} not found under {CONFIG_ROOT}")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        _set(cfg, key.strip(), _parse_value(val.strip()))
    return _resolve(cfg, cfg)
