from satdump_tpu_torch.io.baseband import BasebandReader, BasebandWriter, read_baseband, write_baseband  # noqa: F401
from satdump_tpu_torch.io.baseband import detect_baseband_format  # noqa: F401
from satdump_tpu_torch.io.ziq import read_ziq, write_ziq  # noqa: F401
