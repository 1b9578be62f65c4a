"""Framework exception types (ref: src-core/core/exception.h)."""


class SatdumpError(Exception):
    """Base error for the framework (ref satdump_exception, src-core/core/exception.h)."""


class ConfigError(SatdumpError):
    pass


class PipelineError(SatdumpError):
    pass


class FormatError(SatdumpError):
    pass
