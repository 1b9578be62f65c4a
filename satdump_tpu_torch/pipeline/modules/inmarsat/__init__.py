"""Inmarsat STD-C and Aero decoders and parsers. Importing this package
registers them."""

import satdump_tpu_torch.pipeline.modules.inmarsat.aero_decoder  # noqa: F401
import satdump_tpu_torch.pipeline.modules.inmarsat.aero_parser  # noqa: F401
import satdump_tpu_torch.pipeline.modules.inmarsat.stdc_decoder  # noqa: F401
import satdump_tpu_torch.pipeline.modules.inmarsat.stdc_parser  # noqa: F401
