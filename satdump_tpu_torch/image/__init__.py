from satdump_tpu_torch.image.io import load_img, save_img  # noqa: F401
