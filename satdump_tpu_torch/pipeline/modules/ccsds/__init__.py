import satdump_tpu_torch.pipeline.modules.ccsds.conv_concat  # noqa: F401
