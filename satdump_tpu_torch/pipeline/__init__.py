from satdump_tpu_torch.pipeline.module import ProcessingModule, module_registry, register_module  # noqa: F401
from satdump_tpu_torch.pipeline.pipeline import Pipeline, load_pipelines_file, pipeline_registry  # noqa: F401
