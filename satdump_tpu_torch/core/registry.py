"""Generic string-keyed registries + plugin loading.

The reference extends every registry (processing modules, SDR sources, LDPC
decoders, calibrators, CLI subcommands) through dlopen'd plugins firing
event-bus registration events (src-core/core/plugin.h:10-39). Here plugins are
plain Python modules/entry-points exposing a ``register(event_bus)`` function;
built-in components self-register on import.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Generic, Iterator, Optional, TypeVar

from satdump_tpu_torch.core.exceptions import SatdumpError
from satdump_tpu_torch.core.log import logger

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, key: str, item: T, replace: bool = False) -> None:
        if key in self._items and not replace:
            raise SatdumpError(f"{self.kind} '{key}' already registered")
        self._items[key] = item

    def get(self, key: str) -> T:
        if key not in self._items:
            raise SatdumpError(
                f"unknown {self.kind} '{key}' (have: {', '.join(sorted(self._items))})")
        return self._items[key]

    def get_opt(self, key: str) -> Optional[T]:
        return self._items.get(key)

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def items(self):
        return self._items.items()


def load_plugins(module_names: list[str], event_bus) -> int:
    """Import plugin modules and call their register(event_bus) hook."""
    n = 0
    for name in module_names:
        try:
            mod = importlib.import_module(name)
        except ImportError as e:
            logger.warning(f"plugin {name} failed to import: {e}")
            continue
        reg: Optional[Callable] = getattr(mod, "register", None)
        if reg is None:
            logger.warning(f"plugin {name} has no register()")
            continue
        reg(event_bus)
        n += 1
    return n
