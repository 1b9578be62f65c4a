"""Wrappers of the hand-written CUDA kernels under ``csrc/``.

Each wrapper launches its kernel for a CUDA tensor, runs the plain PyTorch
version for a CPU tensor, and raises for anything else. A failed build or
launch raises; nothing falls back to the plain version on the card.
"""


def _wrappers() -> tuple:
    """Every wrapper of the data paths (each adds one to its `launches`
    where it launches its kernel); the toolchain probe, on no path, is
    left out."""
    from satdump_tpu_torch.ops.cuda.gardner import gardner_walk
    from satdump_tpu_torch.ops.cuda.mm_clock import mm_walk
    from satdump_tpu_torch.ops.cuda.resample import resample_arith_grid
    from satdump_tpu_torch.ops.cuda.resample_strip import resample_strip
    from satdump_tpu_torch.ops.cuda.sample_walk import (agc_walk, costas_walk,
                                                        pll_walk)
    from satdump_tpu_torch.ops.cuda.turbo_bcjr import turbo_bcjr
    from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
    from satdump_tpu_torch.ops.cuda.viterbi_block import (
        viterbi_block_acs, viterbi_block_traceback)
    return (viterbi_re, resample_arith_grid, agc_walk, pll_walk, costas_walk,
            mm_walk, turbo_bcjr, viterbi_block_acs, viterbi_block_traceback,
            gardner_walk, resample_strip)


def launch_counts() -> dict:
    """{wrapper name: kernel launches so far} over every wrapper of the
    data paths."""
    return {k.__name__: k.launches for k in _wrappers()}


def count_launches(counts: dict) -> None:
    """Add {wrapper name: launches} to the wrappers' counts: the launches
    that a CUDA graph's replay made without its wrappers
    (ops/cuda/graph.py)."""
    for k in _wrappers():
        k.launches += counts.get(k.__name__, 0)
