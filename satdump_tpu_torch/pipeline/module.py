"""Processing module base + registry (ref: src-core/pipeline/module.h:58-235).

A ProcessingModule performs one data-level transition (baseband -> soft ->
cadu/frames -> products) reading an input file and writing an output file —
the level-file contract that doubles as checkpointing and the test oracle
(SURVEY.md §5 "checkpoint/resume"). Streaming (FIFO) mode is layered on later;
offline file->file is the primary path.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Type

from satdump_tpu_torch.core.events import RegisterModulesEvent, event_bus
from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.core.registry import Registry


class ProcessingModule:
    """Base class. Subclasses set `id`, implement process(), and set
    self.d_output_file to the path they produced."""

    id: str = "base"

    def __init__(self, input_file: str, output_file_hint: str, parameters: dict):
        self.d_input_file = input_file
        self.d_output_file_hint = output_file_hint
        self.d_parameters = dict(parameters or {})
        self.d_output_file: Optional[str] = None
        self.stats: dict = {}

    # -- lifecycle ----------------------------------------------------------
    def init(self) -> None:
        pass

    def process(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass

    def getModuleStats(self) -> dict:
        return dict(self.stats)

    # -- parameter helpers --------------------------------------------------
    def param(self, key: str, default=None, required: bool = False):
        if key in self.d_parameters:
            return self.d_parameters[key]
        if required:
            raise PipelineError(f"{self.id}: parameter '{key}' must be present")
        return default

    @classmethod
    def getID(cls) -> str:
        return cls.id


module_registry: Registry[Type[ProcessingModule]] = Registry("module")


def register_module(cls: Type[ProcessingModule]) -> Type[ProcessingModule]:
    """Decorator: add a module class to the global registry."""
    module_registry.register(cls.id, cls)
    return cls


_modules_registered = False


def register_all_modules() -> None:
    """Import the ported module packages (they self-register) and fire the
    RegisterModulesEvent so plugins can add theirs (ref module.cpp:91-118).
    Only modules the port carries are registered; any other id raises the
    registry's unknown-module error."""
    global _modules_registered
    if _modules_registered:
        return
    _modules_registered = True
    import satdump_tpu_torch.pipeline.modules  # noqa: F401  (self-registers)
    import satdump_tpu_torch.models  # noqa: F401
    event_bus.fire_event(RegisterModulesEvent(module_registry))
    logger.debug(f"{len(list(module_registry))} processing modules registered")
