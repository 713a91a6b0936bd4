"""Flat dotted-key config (upnerf/config/), read and written without PyYAML."""

from .config import (
    DEFAULT_CONFIG_FILE,
    PRESET_DIR,
    default,
    flatten,
    get_from_path,
    load,
    merge_from_config,
    merge_from_file,
    merge_from_list,
    parse_cli,
    resolve_preset,
    save_yaml,
)

__all__ = [
    "DEFAULT_CONFIG_FILE",
    "PRESET_DIR",
    "default",
    "flatten",
    "get_from_path",
    "load",
    "merge_from_config",
    "merge_from_file",
    "merge_from_list",
    "parse_cli",
    "resolve_preset",
    "save_yaml",
]
