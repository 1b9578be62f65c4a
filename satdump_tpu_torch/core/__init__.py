from satdump_tpu_torch.core.config import Config, get_config  # noqa: F401
from satdump_tpu_torch.core.exceptions import SatdumpError  # noqa: F401
from satdump_tpu_torch.core.log import logger  # noqa: F401
from satdump_tpu_torch.core.registry import Registry  # noqa: F401
from satdump_tpu_torch.core.events import EventBus, event_bus  # noqa: F401
