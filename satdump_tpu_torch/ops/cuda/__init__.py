"""Wrappers of the hand-written CUDA kernels under ``csrc/``.

Each wrapper launches its kernel for a CUDA tensor, runs the plain PyTorch
version for a CPU tensor, and raises for anything else. A failed build or
launch raises; nothing falls back to the plain version on the card.
"""
