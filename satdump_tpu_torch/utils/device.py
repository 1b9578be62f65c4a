"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. Asking for
``cuda`` where PyTorch sees no card raises: nothing silently continues on
the CPU. Tensors carry their device from then on, and every op dispatches
on the device of the tensor it is given.
"""

from __future__ import annotations

import torch

from satdump_tpu_torch.core.exceptions import SatdumpError

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device` (default ``cuda``) as a torch.device; raises if it names
    CUDA and no card is visible."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SatdumpError(
            f"device '{dev}' requested but torch.cuda.is_available() is False"
            " (pass device='cpu' / torch_device: cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise SatdumpError(f"unsupported device '{dev}' (cuda or cpu)")
    return dev


def div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v, correctly rounded on every device. (PyTorch's CUDA kernel
    multiplies by the reciprocal when the divisor is a Python number, which
    can differ from the division in the last bit; a tensor divisor divides.)
    """
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


class full_precision_matmul:
    """float32 matmuls at full precision inside the block: on the card,
    TF32 would round their inputs to 10 mantissa bits."""

    def __enter__(self):
        self._tf32 = torch.backends.cuda.matmul.allow_tf32
        self._prec = torch.get_float32_matmul_precision()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._tf32
        torch.set_float32_matmul_precision(self._prec)
        return False


def to_numpy(t: torch.Tensor):
    """Tensor -> host numpy array (synchronizes with the card)."""
    return t.detach().cpu().numpy()


def is_device_fault(e: BaseException) -> bool:
    """Whether `e` is a fault of the card (a CUDA error, an out-of-memory,
    an asynchronous kernel fault) rather than of the work's input. Code
    that logs and skips a failing item, as the reference's products
    processor does, raises these instead. (PyTorch raises them as
    RuntimeError subclasses whose message names CUDA, as do the kernel
    wrappers' launch checks.)"""
    return isinstance(e, RuntimeError) and "CUDA" in str(e)
