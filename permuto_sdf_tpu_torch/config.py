"""Configuration files and ``key=value`` overrides on the trainers'
dataclasses (counterpart of ``permuto_sdf_tpu/config.py``, copied: the
same regular expressions, so both packages read a file the same way).

Every pipeline's knobs live in a dataclass (``*TrainConfig``); this module
loads overrides from an hjson-style file and/or ``key=value`` CLI pairs
onto it. The file format takes hjson's ``//`` and ``/* */`` comments,
trailing commas and unquoted keys, with no dependency outside the standard
library (``config/*.cfg``).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Type, TypeVar

T = TypeVar("T")


def _strip_hjson(text: str) -> str:
    # remove /* */ and // comments (outside strings: enough for configs)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    text = re.sub(r"(^|\s)//[^\n]*", r"\1", text)
    # quote unquoted keys:  foo: 1  ->  "foo": 1
    text = re.sub(r"(?m)^(\s*)([A-Za-z_][A-Za-z0-9_]*)\s*:", r'\1"\2":', text)
    # remove trailing commas
    text = re.sub(r",(\s*[}\]])", r"\1", text)
    return text


def load_config_dict(path: str) -> dict:
    with open(path) as f:
        return json.loads(_strip_hjson(f.read()))


def _coerce(value: Any, target_type: Any) -> Any:
    if target_type in (int, float, bool, str) and isinstance(value, str):
        if target_type is bool:
            return value.lower() in ("1", "true", "yes", "on")
        return target_type(value)
    if target_type is tuple and isinstance(value, (list, tuple)):
        return tuple(value)
    return value


def apply_overrides(cfg: T, overrides: dict) -> T:
    """A copy of the dataclass ``cfg`` with ``overrides`` applied. An
    unknown key raises ``KeyError``."""
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    updates = {}
    for k, v in overrides.items():
        if k not in fields:
            raise KeyError(
                f"unknown config key '{k}' for {type(cfg).__name__}; "
                f"valid keys: {sorted(fields)}"
            )
        updates[k] = _coerce(v, fields[k].type if isinstance(fields[k].type, type)
                             else type(getattr(cfg, k)))
    return dataclasses.replace(cfg, **updates)


def apply_file_and_cli(cfg: T, path: str | None = None,
                       cli_overrides: list[str] | None = None) -> T:
    """Layer the file's overrides, then ``key=value`` CLI overrides, onto
    an existing config instance (whose values are the base)."""
    if path:
        cfg = apply_overrides(cfg, load_config_dict(path))
    if cli_overrides:
        kv = {}
        for item in cli_overrides:
            if "=" not in item:
                raise ValueError(f"override '{item}' is not key=value")
            k, v = item.split("=", 1)
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass  # keep as string; _coerce handles typed fields
            kv[k] = v
        cfg = apply_overrides(cfg, kv)
    return cfg


def load_config(cfg_type: Type[T], path: str | None = None,
                cli_overrides: list[str] | None = None, **kwargs) -> T:
    """``cfg_type()``, then the file's overrides, then ``key=value`` CLI
    overrides, then explicit kwargs (highest priority)."""
    cfg = apply_file_and_cli(cfg_type(), path, cli_overrides)
    if kwargs:
        cfg = apply_overrides(cfg, kwargs)
    return cfg
