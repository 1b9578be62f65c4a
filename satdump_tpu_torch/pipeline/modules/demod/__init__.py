import satdump_tpu_torch.pipeline.modules.demod.psk  # noqa: F401
