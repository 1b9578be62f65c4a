"""Pipeline model + JSON loader, compatible with the reference's pipeline files.

Reference: src-core/pipeline/pipeline.{h,cpp}. A pipeline file maps
pipeline-id -> {name, live, frequencies, parameters, work:{level: {module,
parameters}}}. We parse the same schema (including /* */ comments some files
contain and ``.json.inc`` includes, pipeline.cpp:16-32) so the reference's
resources/pipelines/*.json load unchanged.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core.registry import Registry


@dataclass
class PipelineStep:
    level: str                      # output data level ("soft", "cadu", ...)
    module_id: str                  # "" for the input level (e.g. "baseband")
    parameters: dict = field(default_factory=dict)
    input_override: Optional[str] = None


@dataclass
class Pipeline:
    id: str
    name: str
    steps: List[PipelineStep] = field(default_factory=list)
    parameters: dict = field(default_factory=dict)   # editable/default params
    frequencies: List[tuple] = field(default_factory=list)
    live_cfg: List[int] = field(default_factory=list)

    def level_index(self, level: str) -> int:
        for i, s in enumerate(self.steps):
            if s.level == level:
                return i
        raise PipelineError(
            f"pipeline {self.id}: unknown level '{level}' "
            f"(have {[s.level for s in self.steps]})")

    def prepare_parameters(self, step: PipelineStep, user_params: dict) -> dict:
        """Merge defaults < pipeline params < step params < user overrides
        (ref prepareParameters, pipeline_run.cpp:215-229)."""
        out: dict = {}
        for k, v in self.parameters.items():
            out[k] = v["value"] if isinstance(v, dict) and "value" in v else v
        out.update(step.parameters)
        for k, v in (user_params or {}).items():
            out[k] = v
        return out


def _strip_json_comments(text: str) -> str:
    """Remove /* */ and // comments, string-aware — the reference's pipeline
    files contain both (Meteor-M.json:169 block, :265 line)."""
    out = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
        elif c == '"':
            in_str = True
            out.append(c)
            i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            end = text.find("*/", i + 2)
            i = n if end < 0 else end + 2
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            end = text.find("\n", i)
            i = n if end < 0 else end
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _expand_includes(text: str, path: Path,
                     include_dirs: Optional[List[Path]] = None) -> str:
    """Textual ``"*.json.inc"`` substitution BEFORE JSON parsing — the
    reference replaces the quoted token with the raw file contents
    (pipeline.cpp:25-67), so includes can supply any fragment, including
    the ``work`` dict itself."""
    def repl(m: re.Match) -> str:
        name = m.group(1)
        for d in [path.parent] + list(include_dirs or []):
            cand = Path(d) / name
            if cand.exists():
                return cand.read_text()
        from satdump_tpu_torch.core.log import logger
        logger.error(f"could not include {name} from {path}")
        return m.group(0)

    return re.sub(r'"([^"\n]+\.json\.inc)"', repl, text)


def parse_pipeline_file(path: str | Path, include_dirs: Optional[List[Path]] = None
                        ) -> Dict[str, Pipeline]:
    path = Path(path)
    text = _expand_includes(path.read_text(), path, include_dirs)
    text = _strip_json_comments(text)
    data = json.loads(text)
    out: Dict[str, Pipeline] = {}
    for pid, body in data.items():
        if not isinstance(body, dict) or "work" not in body:
            continue
        steps = []
        for level, step in body.get("work", {}).items():
            steps.append(PipelineStep(
                level=level,
                module_id=step.get("module", ""),
                parameters=step.get("parameters", {}) or {},
                input_override=step.get("input_override"),
            ))
        out[pid] = Pipeline(
            id=pid,
            name=body.get("name", pid),
            steps=steps,
            parameters=body.get("parameters", {}) or {},
            frequencies=[tuple(f) for f in body.get("frequencies", [])],
            live_cfg=body.get("live", []) or [],
        )
    return out


pipeline_registry: Registry[Pipeline] = Registry("pipeline")


def load_pipelines_file(path: str | Path) -> int:
    n = 0
    for pid, p in parse_pipeline_file(path).items():
        pipeline_registry.register(pid, p, replace=True)
        n += 1
    return n


def load_pipelines_dir(directory: str | Path) -> int:
    n = 0
    for f in sorted(Path(directory).glob("*.json")):
        try:
            n += load_pipelines_file(f)
        except Exception as e:
            from satdump_tpu_torch.core.log import logger
            logger.warning(f"failed to load pipelines from {f}: {e}")
    return n
