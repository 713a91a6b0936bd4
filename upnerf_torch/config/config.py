"""Flat dotted-key YAML config (upnerf/config/config.py).

- YAML files are flattened to one level of dotted keys ("nerf.N_samples").
- Every string value is `ast.literal_eval`'d when it can be, so "1e-3" and
  "[0.1, 0.5]" become float / tuple; "true" / "false" in any case become
  bools first.
- Lists become tuples.
- Merging is unchecked: unknown keys are added.
- CLI overrides are a flat `key value` remainder list.
- `save_yaml` re-nests the dotted keys and writes the resolved config, which
  tto / eval read back.

The files are read and written by `yaml_subset` (the GPU host has no PyYAML),
which reads scalars as PyYAML's safe_load does; `default.yaml` and the presets
are this package's copies of upnerf/config's.
"""

from __future__ import annotations

import argparse
import os
from ast import literal_eval
from os.path import dirname, join
from typing import Any, Dict, Iterable, Optional

from . import yaml_subset

DEFAULT_CONFIG_FILE = join(dirname(__file__), "default.yaml")
PRESET_DIR = join(dirname(__file__), "presets")


def resolve_preset(name: str) -> str:
    """A --preset argument: a yaml path, or the name of a packaged preset
    (e.g. ``best_pose``). Presets merge after the scene config and before
    the `key value` overrides."""
    if os.path.isfile(name):
        return name
    path = join(PRESET_DIR, name + ".yaml")
    if os.path.isfile(path):
        return path
    avail = sorted(f[:-5] for f in os.listdir(PRESET_DIR) if f.endswith(".yaml"))
    raise FileNotFoundError(f"unknown preset {name!r}: not a file, and not one of {avail}")


def _coerce(v: Any) -> Any:
    if isinstance(v, str):
        # literal_eval knows only "True" / "False": `tpu.fused_train false` must not stay a string
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        try:
            v = literal_eval(v)
        except (ValueError, SyntaxError):
            pass  # really a string
    if isinstance(v, list):
        v = tuple(v)
    return v


def flatten(d: Optional[Dict], prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested dict into dotted keys, coercing values."""
    out: Dict[str, Any] = {}
    if d is None:
        return out
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix=prefix + str(k) + "."))
        else:
            out[prefix + str(k)] = _coerce(v)
    return out


def load(fname: str) -> Dict[str, Any]:
    with open(fname, "r") as fp:
        return flatten(yaml_subset.safe_load(fp.read()))


def merge_from_config(config: Dict[str, Any], config_merge: Dict[str, Any]) -> None:
    for k, v in config_merge.items():
        config[k] = v


def merge_from_file(config: Dict[str, Any], fname: str) -> None:
    merge_from_config(config, load(fname))


def merge_from_list(config: Dict[str, Any], list_merge: Iterable[str]) -> None:
    list_merge = list(list_merge)
    if len(list_merge) % 2:
        raise ValueError(f"overrides must be `key value` pairs, got {list_merge}")
    merge_from_config(config, flatten(dict(zip(list_merge[0::2], list_merge[1::2]))))


def default() -> Dict[str, Any]:
    return load(DEFAULT_CONFIG_FILE)


def parse_cli(parser: argparse.ArgumentParser, argv: Optional[list] = None) -> Dict[str, Any]:
    """default.yaml -> --config file -> --preset files -> `key value`
    overrides -> the other argparse attributes (where the config lacks them)."""
    args = parser.parse_args(argv)
    config = default()
    config_path = getattr(args, "config", None)
    if config_path is not None:
        merge_from_file(config, config_path)
    for preset in getattr(args, "preset", None) or ():
        merge_from_file(config, resolve_preset(preset))
    opts = getattr(args, "opts", None)
    if opts:
        merge_from_list(config, opts)
    for k, v in vars(args).items():
        if k not in config:
            config[k] = v
    return config


def get_from_path(config_path: Optional[str]) -> Dict[str, Any]:
    config = default()
    if config_path is not None:
        merge_from_file(config, config_path)
    return config


def save_yaml(config: Dict[str, Any], file_name: str) -> None:
    """Re-nest the dotted keys and write the config."""
    nested: Dict[str, Any] = {}
    for k, v in config.items():
        keys = k.split(".")
        cur = nested
        for key in keys[:-1]:
            cur = cur.setdefault(key, {})
        if isinstance(v, tuple):
            v = list(v)
        cur[keys[-1]] = v
    with open(file_name, "w") as fp:
        yaml_subset.safe_dump(nested, fp)
