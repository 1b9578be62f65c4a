import satdump_tpu_torch.pipeline.modules.ccsds.conv_concat  # noqa: F401
import satdump_tpu_torch.pipeline.modules.ccsds.simple_psk  # noqa: F401
