"""Per-mission decoders/instruments (the reference's plugins/*_support analog).

Importing this package registers the mission modules the port carries:
`metop_instruments` and `meteor_msumr_lrpt`.
"""

import satdump_tpu_torch.models.metop  # noqa: F401
import satdump_tpu_torch.models.meteor  # noqa: F401
