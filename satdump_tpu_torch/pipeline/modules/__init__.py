"""Ported processing modules. Importing this package registers them all."""

import satdump_tpu_torch.pipeline.modules.demod  # noqa: F401
import satdump_tpu_torch.pipeline.modules.ccsds  # noqa: F401
import satdump_tpu_torch.pipeline.modules.dvbs2  # noqa: F401
import satdump_tpu_torch.pipeline.modules.inmarsat  # noqa: F401
import satdump_tpu_torch.pipeline.modules.network  # noqa: F401
import satdump_tpu_torch.pipeline.modules.xrit_net  # noqa: F401
import satdump_tpu_torch.pipeline.modules.convert  # noqa: F401
import satdump_tpu_torch.xrit.geo  # noqa: F401
import satdump_tpu_torch.xrit.gk2a  # noqa: F401
import satdump_tpu_torch.xrit.goes  # noqa: F401
import satdump_tpu_torch.pipeline.modules.analog  # noqa: F401
