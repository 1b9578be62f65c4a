"""Webhook observability sink.

Reference: plugins/webhook_app/webhook.cpp — POST a JSON notification to a
configured URL on PipelineDoneProcessingEvent. Registers on the event bus;
failures only log (the hot path never depends on the sink)."""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Optional

from satdump_tpu_torch.core.events import PipelineDoneProcessingEvent, event_bus
from satdump_tpu_torch.core.log import logger


class WebhookSink:
    def __init__(self, url: str, timeout: float = 10.0,
                 run_async: bool = True):
        self.url = url
        self.timeout = timeout
        self.run_async = run_async
        event_bus.register_handler(PipelineDoneProcessingEvent, self._on_done)

    def _post(self, payload: dict) -> None:
        try:
            req = urllib.request.Request(
                self.url, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=self.timeout).read()
        except Exception as e:
            logger.warning(f"webhook POST failed: {e}")

    def _on_done(self, ev: PipelineDoneProcessingEvent) -> None:
        payload = {"event": "pipeline_done", "pipeline": ev.pipeline_id,
                   "output_dir": ev.output_dir}
        if self.run_async:
            threading.Thread(target=self._post, args=(payload,),
                             daemon=True).start()
        else:
            self._post(payload)
