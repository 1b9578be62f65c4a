"""Layered, self-describing JSON configuration.

Mirrors the reference's config contract (src-core/core/config.h:26-43 and
satdump_cfg.json): every leaf setting is a dict
``{"type": ..., "value": ..., "name": ..., "description": ...}`` so UIs and
CLIs can be generated automatically; a system config is deep-merged with user
overrides (only ``value`` fields are kept in the user layer).
"""

from __future__ import annotations

import copy
import json
import os
from pathlib import Path
from typing import Any, Optional

from satdump_tpu_torch.core.exceptions import ConfigError


def _deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def is_setting(node: Any) -> bool:
    """True if a node is a self-describing setting leaf ({type,value,...})."""
    return isinstance(node, dict) and "value" in node and (
        "type" in node or "name" in node or "description" in node or len(node) == 1
    )


class Config:
    """System + user layered config (ref SatDumpConfigHandler, core/config.h:26)."""

    def __init__(self, system: Optional[dict] = None, user: Optional[dict] = None):
        self.system_cfg: dict = system or {}
        self.user_cfg: dict = user or {}
        self.main_cfg: dict = _deep_merge(self.system_cfg, self.user_cfg)

    # -- loading ------------------------------------------------------------
    @classmethod
    def load(cls, system_path: str | Path, user_path: Optional[str | Path] = None) -> "Config":
        with open(system_path) as f:
            system = json.load(f)
        user = {}
        if user_path and os.path.exists(user_path):
            with open(user_path) as f:
                user = json.load(f)
        return cls(system, user)

    def save_user(self, user_path: str | Path) -> None:
        Path(user_path).parent.mkdir(parents=True, exist_ok=True)
        with open(user_path, "w") as f:
            json.dump(self.user_cfg, f, indent=4)

    # -- access -------------------------------------------------------------
    def get(self, dotted: str, default: Any = None) -> Any:
        """Get a value by dotted path; unwraps {type,value,...} leaves."""
        node: Any = self.main_cfg
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        if is_setting(node):
            return node["value"]
        return node

    def set_user(self, dotted: str, value: Any) -> None:
        """Set a user-layer override (stored as bare {"value": ...} leaf)."""
        parts = dotted.split(".")
        node = self.user_cfg
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ConfigError(f"config path collision at {part} in {dotted}")
        node[parts[-1]] = {"value": value}
        self.main_cfg = _deep_merge(self.system_cfg, self.user_cfg)


_DEFAULT_SYSTEM_CFG: dict = {
    "satdump_general": {
        "log_level": {"type": "options", "value": "info", "name": "Log level",
                      "description": "Minimum severity printed to the console",
                      "options": ["trace", "debug", "info", "warning", "error"]},
        "block_size": {"type": "int", "value": 1 << 20, "name": "DSP block size",
                       "description": "Samples per device block for batched DSP"},
        "tle_update_interval": {"type": "int", "value": 24 * 3600, "name": "TLE update interval",
                                "description": "Seconds between TLE refreshes"},
    },
}

_config: Optional[Config] = None


def get_config() -> Config:
    """Global config singleton, lazily created with built-in defaults."""
    global _config
    if _config is None:
        cfg_path = os.environ.get("SATDUMP_TPU_CFG", "")
        user_path = os.path.join(
            os.environ.get("XDG_CONFIG_HOME", os.path.expanduser("~/.config")),
            "satdump_tpu_torch", "settings.json")
        if cfg_path and os.path.exists(cfg_path):
            _config = Config.load(cfg_path, user_path)
        else:
            user = {}
            if os.path.exists(user_path):
                with open(user_path) as f:
                    user = json.load(f)
            _config = Config(copy.deepcopy(_DEFAULT_SYSTEM_CFG), user)
    return _config
