"""Type-keyed synchronous pub/sub event bus (ref: src-core/utils/event_bus.h:28-60).

The reference uses this as its universal extension mechanism: plugins register
handlers for event structs (RegisterModulesEvent, RequestImageCalibratorEvent,
...). We key on the event class and call handlers synchronously in
registration order.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List, Type


class EventBus:
    def __init__(self) -> None:
        self._handlers: Dict[Type, List[Callable[[Any], None]]] = defaultdict(list)

    def register_handler(self, event_type: Type, fn: Callable[[Any], None]) -> None:
        self._handlers[event_type].append(fn)

    def fire_event(self, event: Any) -> None:
        for fn in list(self._handlers.get(type(event), ())):
            fn(event)


event_bus = EventBus()


# -- standard events (mirroring the reference's) ----------------------------
class SatdumpStartedEvent:
    pass


class RegisterModulesEvent:
    """Handlers append (id, factory) into `registry` (ref pipeline/module.h:213)."""

    def __init__(self, registry):
        self.registry = registry


class PipelineDoneProcessingEvent:
    def __init__(self, pipeline_id: str, output_dir: str):
        self.pipeline_id = pipeline_id
        self.output_dir = output_dir
