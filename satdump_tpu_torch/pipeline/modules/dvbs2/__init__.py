"""DVB-S2 pipeline modules (baseband -> bbframe -> ts) and the DVB-S
demodulator (baseband -> ts)."""

import satdump_tpu_torch.pipeline.modules.dvbs2.demod  # noqa: F401
import satdump_tpu_torch.pipeline.modules.dvbs2.dvbs  # noqa: F401
import satdump_tpu_torch.pipeline.modules.dvbs2.ts_extractor  # noqa: F401
