"""Offline pipeline runner (ref: src-core/pipeline/pipeline_run.cpp:14-213).

Runs a pipeline from a given data level: seeks to the level, instantiates
each step's module, runs them file -> file (each emitted level file is a
durable checkpoint / golden artifact), then fires the done event. The
reference's special-cased 2-module thread fusion is unnecessary here — each
module already processes in large batched blocks. When the last module
wrote a dataset.json, the products processor renders its composites on the
pipeline's `torch_device`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from satdump_tpu_torch.core.events import PipelineDoneProcessingEvent, event_bus
from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core import trace
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.pipeline.module import module_registry, register_all_modules
from satdump_tpu_torch.pipeline.pipeline import Pipeline
from satdump_tpu_torch.utils.device import is_device_fault


def run_pipeline(pipeline: Pipeline, input_file: str, output_dir: str,
                 user_params: Optional[dict] = None, start_level: str = "baseband"
                 ) -> str:
    """Run `pipeline` on input_file starting at start_level. Returns the last
    output file produced. Mirrors Pipeline::run (pipeline_run.cpp)."""
    register_all_modules()
    user_params = dict(user_params or {})
    if start_level == "baseband":
        # fill samplerate/baseband_format from the input's header or
        # extension when not given (ref try_get_params_from_input_file)
        from satdump_tpu_torch.io.detect import apply_header_params
        apply_header_params(user_params, input_file)
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    start_idx = pipeline.level_index(start_level)
    steps = pipeline.steps[start_idx + 1:]
    if not steps:
        raise PipelineError(f"nothing to do from level '{start_level}'")

    cur_input = input_file
    last_output = input_file
    hint = str(out_dir / pipeline.id)

    for step in steps:
        if not step.module_id:
            continue
        params = pipeline.prepare_parameters(step, user_params)
        cls = module_registry.get(step.module_id)
        mod = cls(cur_input, hint, params)
        logger.info(f"[{pipeline.id}] {step.module_id}: {cur_input} -> level '{step.level}'")
        with trace.timed(f"step.{step.module_id}") as span:
            mod.init()
            mod.process()
            mod.stop()
        stats = mod.getModuleStats()
        logger.info(f"[{pipeline.id}] {step.module_id} done in "
                    f"{span.ns / 1e9:.1f}s "
                    + (f"stats={stats}" if stats else ""))
        if mod.d_output_file:
            cur_input = mod.d_output_file
            last_output = mod.d_output_file

    # auto-process products when the last module wrote a dataset (ref
    # pipeline_run.cpp:172-207: Pipeline::run appends the products processor
    # whenever dataset.json appears) — composites come out of the single
    # `pipeline` invocation, no separate `process` command needed
    dataset = out_dir / "dataset.json"
    if dataset.exists():
        from satdump_tpu_torch.products.processor import process_path
        try:
            written = process_path(str(dataset), device=user_params.get(
                "torch_device", "cuda"))
            logger.info(f"[{pipeline.id}] products processor: "
                        f"{len(written)} composites")
        except Exception as e:  # never fail the pipeline on compositing
            if is_device_fault(e):
                raise
            logger.error(f"[{pipeline.id}] products processing failed: {e}")

    event_bus.fire_event(PipelineDoneProcessingEvent(pipeline.id, str(out_dir)))
    return last_output
