"""The few ways the benchmark reaches into the program: its pipeline
registry as the CLI loads it, its logger's level, and the user parameters a
run passes. Everything else the drivers call is a user's entry point."""

from __future__ import annotations

import copy


def pipeline(cfg: dict, start: str, stop: str):
    """The configuration's pipeline from the program's registry, as the
    CLI's `pipeline` and `live` commands load it, cut to the levels
    start..stop. Raises where the registry's parameters are not the ones the
    configuration file states."""
    from satdump_tpu_torch.cli import _load_all_pipelines
    from satdump_tpu_torch.pipeline.pipeline import pipeline_registry
    _load_all_pipelines()
    pipe = copy.deepcopy(pipeline_registry.get(cfg["pipeline"]))
    want = cfg["pipeline_parameters"]
    have = {k: v.get("value", v) if isinstance(v, dict) else v
            for k, v in pipe.parameters.items()}
    for st in pipe.steps:
        if st.module_id and st.level in want:
            have[st.level] = dict(st.parameters, module=st.module_id)
    if {k: have.get(k) for k in want} != want:
        raise RuntimeError(f"pipeline {cfg['pipeline']} has parameters "
                           f"{have}, the configuration states {want}")
    pipe.steps = pipe.steps[pipe.level_index(start):
                            pipe.level_index(stop) + 1]
    return pipe


def user_params(device: str) -> dict:
    """What a user passes: nothing on the card, where `cuda` is the
    modules' default; `torch_device: cpu` for a dry run on the CPU."""
    return {} if device == "cuda" else {"torch_device": device}


def quiet() -> None:
    """Warnings and errors only from the program's logger, so that a run's
    standard error ends with its checks."""
    from satdump_tpu_torch.core.log import set_level
    set_level("warning")


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
