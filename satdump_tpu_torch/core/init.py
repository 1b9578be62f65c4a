"""Framework boot sequence.

Reference: src-core/init.cpp initSatDump() — config load, plugin load,
module registration, pipeline load, DBs, products, task scheduler start,
then SatDumpStartedEvent. The lazy per-subsystem registration still works
without calling this; init_satdump() is the explicit one-call boot the CLI
and embedders use."""

from __future__ import annotations

from typing import Optional

from satdump_tpu_torch.core.config import Config
from satdump_tpu_torch.core.events import SatdumpStartedEvent, event_bus
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.core.registry import load_plugins
from satdump_tpu_torch.core.tasks import task_scheduler

config: Config = Config()

_initialized = False


def init_satdump(pipelines_dirs: Optional[list] = None,
                 start_tasks: bool = False) -> None:
    """Boot: config -> plugins -> modules -> pipelines -> products ->
    [task scheduler] -> SatdumpStartedEvent (init.cpp:45-181 order)."""
    global _initialized, config
    if _initialized:
        return
    import os
    from pathlib import Path
    cfg_path = Path(__file__).resolve().parent.parent.parent \
        / "resources" / "satdump_cfg.json"
    user_path = os.path.expanduser("~/.config/satdump_tpu/settings.json")
    if cfg_path.exists():
        config = Config.load(cfg_path, user_path)
    plugins = config.get("plugins", []) or []
    if plugins:
        load_plugins(list(plugins), event_bus)
    from satdump_tpu_torch.pipeline.module import register_all_modules
    register_all_modules()
    from satdump_tpu_torch.pipeline.pipeline import load_pipelines_dir
    import satdump_tpu_torch.products  # noqa: F401 (loader registry)
    default_dir = Path(__file__).resolve().parent.parent.parent \
        / "resources" / "pipelines"
    for d in [str(default_dir)] + list(pipelines_dirs or []):
        try:
            load_pipelines_dir(d)
        except FileNotFoundError:
            pass
    if start_tasks:
        task_scheduler.start()
    _initialized = True
    event_bus.fire_event(SatdumpStartedEvent())
    logger.debug("satdump_tpu_torch initialized")
