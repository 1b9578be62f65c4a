"""DSP + FEC ops: plain PyTorch functions on tensors, plus the wrappers of
the hand-written CUDA kernels (``ops/cuda``)."""
