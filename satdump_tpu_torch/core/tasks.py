"""Periodic task scheduler.

Reference: src-core/utils/task_scheduler.h — one background thread walking
registered {event, interval} entries and firing them on the event bus when
due (used for TLE auto-refresh etc., init.cpp:180). `tick(now)` is exposed
for deterministic tests; `start()` runs it on a daemon thread.

A copy of satdump_tpu/core/tasks.py, its imports rewritten to the port.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from satdump_tpu_torch.core.events import event_bus
from satdump_tpu_torch.core.log import logger


@dataclass
class ScheduledTask:
    name: str
    make_event: Callable[[], Any]
    interval_s: float
    last_run: float = 0.0
    run_at_startup: bool = True


class TaskScheduler:
    def __init__(self):
        self._tasks: Dict[str, ScheduledTask] = {}
        self._thread: Optional[threading.Thread] = None
        self._run = False

    def add_task(self, name: str, make_event: Callable[[], Any],
                 interval_s: float, run_at_startup: bool = True) -> None:
        self._tasks[name] = ScheduledTask(name, make_event, interval_s,
                                          0.0 if run_at_startup else
                                          time.time(), run_at_startup)

    def del_task(self, name: str) -> None:
        self._tasks.pop(name, None)

    def tick(self, now: Optional[float] = None) -> List[str]:
        """Fire every due task; returns the names fired."""
        now = time.time() if now is None else now
        fired = []
        for t in list(self._tasks.values()):
            if now - t.last_run >= t.interval_s:
                t.last_run = now
                try:
                    event_bus.fire_event(t.make_event())
                    fired.append(t.name)
                except Exception as e:
                    logger.error(f"task {t.name} failed: {e}")
        return fired

    def start(self, period_s: float = 1.0) -> None:
        self._run = True

        def loop():
            while self._run:
                self.tick()
                time.sleep(period_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._run = False
        if self._thread:
            self._thread.join(timeout=2)


task_scheduler = TaskScheduler()


class UpdateTLEsEvent:
    """Fired periodically to refresh the TLE store (ref
    db/kepler/kepler_handler.h auto-update)."""
