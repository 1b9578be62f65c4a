import satdump_tpu_torch.pipeline.modules.demod.psk  # noqa: F401
import satdump_tpu_torch.pipeline.modules.demod.pm  # noqa: F401
import satdump_tpu_torch.pipeline.modules.demod.fsk  # noqa: F401
import satdump_tpu_torch.pipeline.modules.demod.fm  # noqa: F401
