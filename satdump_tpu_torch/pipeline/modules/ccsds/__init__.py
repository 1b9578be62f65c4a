import satdump_tpu_torch.pipeline.modules.ccsds.conv_concat  # noqa: F401
import satdump_tpu_torch.pipeline.modules.ccsds.simple_psk  # noqa: F401
import satdump_tpu_torch.pipeline.modules.ccsds.ldpc_decoder  # noqa: F401
import satdump_tpu_torch.pipeline.modules.ccsds.turbo_decoder  # noqa: F401
