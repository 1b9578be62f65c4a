"""products subpackage."""

import satdump_tpu_torch.products.calibrators  # noqa: F401  (registers calibrators)
