"""Wrappers of the hand-written CUDA kernels under ``csrc/``.

Each wrapper launches its kernel for a CUDA tensor, runs the plain PyTorch
version for a CPU tensor, and raises for anything else. A failed build or
launch raises; nothing falls back to the plain version on the card.
"""


def launch_counts() -> dict:
    """{wrapper name: kernel launches so far} over every wrapper of the
    data paths (each adds one where it launches its kernel); the toolchain
    probe, on no path, is left out."""
    from satdump_tpu_torch.ops.cuda.gardner import gardner_walk
    from satdump_tpu_torch.ops.cuda.mm_clock import mm_walk
    from satdump_tpu_torch.ops.cuda.resample import resample_arith_grid
    from satdump_tpu_torch.ops.cuda.sample_walk import (agc_walk, costas_walk,
                                                        pll_walk)
    from satdump_tpu_torch.ops.cuda.turbo_bcjr import turbo_bcjr
    from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
    from satdump_tpu_torch.ops.cuda.viterbi_block import (
        viterbi_block_acs, viterbi_block_traceback)
    return {k.__name__: k.launches
            for k in (viterbi_re, resample_arith_grid, agc_walk, pll_walk,
                      costas_walk, mm_walk, turbo_bcjr, viterbi_block_acs,
                      viterbi_block_traceback, gardner_walk)}
