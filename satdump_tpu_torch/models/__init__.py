"""Per-mission decoders/instruments (the reference's plugins/*_support analog).

Importing this package registers the mission modules the port carries:
`metop_instruments`, `meteor_msumr_lrpt`, `noaa_apt_decoder` and
`goes_grb_cadu_extractor`.
"""

import satdump_tpu_torch.models.metop  # noqa: F401
import satdump_tpu_torch.models.meteor  # noqa: F401
import satdump_tpu_torch.models.noaa_apt  # noqa: F401
import satdump_tpu_torch.models.goes_grb  # noqa: F401
