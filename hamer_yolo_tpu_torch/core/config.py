"""Configuration overrides on the frozen config dataclasses (port of
hamer_yolo_tpu/core/config.py).

The config is the tree of frozen dataclasses defined next to each model
(YoloConfig, HamerConfig, SarConfig, PipelineConfig, ...). This loader
applies nested dict overrides, read from a TOML or JSON file or from
"a.b.c=value" dotted strings, and returns a new frozen instance. A key the
dataclass does not have raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Sequence


def load_config_file(path: str) -> Dict[str, Any]:
    """A TOML file (by its ``.toml`` suffix) or a JSON file -> nested dict."""
    if path.endswith(".toml"):
        import tomllib

        with open(path, "rb") as f:
            return tomllib.load(f)
    with open(path) as f:
        return json.load(f)


def _coerce(value: str) -> Any:
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return value


def overrides_from_dotted(pairs: Sequence[str]) -> Dict[str, Any]:
    """["hamer.tome_r=4", "conf_thres=0.3"] -> nested dict, values read as
    int, float or bool where they parse as one, else kept as strings."""
    out: Dict[str, Any] = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _coerce(value.strip())
    return out


def apply_overrides(cfg: Any, overrides: Mapping[str, Any]) -> Any:
    """A copy of a (nested, frozen) dataclass with ``overrides`` applied;
    a key the dataclass does not have raises ``KeyError``."""
    if not dataclasses.is_dataclass(cfg):
        return overrides  # leaf replacement
    valid = {f.name for f in dataclasses.fields(cfg)}
    changes: Dict[str, Any] = {}
    for key, value in overrides.items():
        if key not in valid:
            raise KeyError(f"unknown config key '{key}' for {type(cfg).__name__}; "
                           f"valid: {sorted(valid)}")
        current = getattr(cfg, key)
        if isinstance(value, Mapping) and dataclasses.is_dataclass(current):
            changes[key] = apply_overrides(current, value)
        else:
            changes[key] = value
    return dataclasses.replace(cfg, **changes)


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    return cfg


def describe(cfg: Any) -> str:
    return json.dumps(config_to_dict(cfg), indent=2, default=str)
