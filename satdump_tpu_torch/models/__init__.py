"""Per-mission decoders/instruments (the reference's plugins/*_support analog).

Importing this package registers the mission modules the port carries:
`metop_instruments`, `meteor_msumr_lrpt`, `noaa_apt_decoder`,
`goes_grb_cadu_extractor`, `goes_grb_data_decoder`, `fengyun_ahrpt_decoder` and `fy3_instruments`,
the NOAA HRPT / GAC / DSB decoders and `noaa_instruments`,
`meteor_hrpt_decoder` and `meteor_instruments`, `jpss_instruments`,
`aqua_db_decoder` and `eos_instruments`, the GOES GVAR, sensor-data and
MDL decoders, `orbcomm_stx_deframer` and `orbcomm_plotter`, and
`radiosonde_m10_decoder`.
"""

import satdump_tpu_torch.models.metop  # noqa: F401
import satdump_tpu_torch.models.meteor  # noqa: F401
import satdump_tpu_torch.models.noaa_apt  # noqa: F401
import satdump_tpu_torch.models.goes_grb  # noqa: F401
import satdump_tpu_torch.models.fengyun3  # noqa: F401
import satdump_tpu_torch.models.noaa_hrpt  # noqa: F401
import satdump_tpu_torch.models.meteor_hrpt  # noqa: F401
import satdump_tpu_torch.models.jpss  # noqa: F401
import satdump_tpu_torch.models.eos  # noqa: F401
import satdump_tpu_torch.models.goes_gvar  # noqa: F401
import satdump_tpu_torch.models.goes_sd  # noqa: F401
import satdump_tpu_torch.models.orbcomm  # noqa: F401
import satdump_tpu_torch.models.radiosonde  # noqa: F401
