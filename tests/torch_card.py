"""What the `card` tests share: the `card` fixture, the kernels' launch
counts around a call, and a built library's SASS.

A `card` test runs on a machine with a CUDA card and skips elsewhere. The
files that hold them import no JAX, nothing of the satdump_tpu package and
no PIL, so that they run on the card's host, which has no PIL and where the
JAX package does not run:

    python3 -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_card_kernels.py tests/test_torch_card_pipelines.py \\
        tests/test_torch_resample_strip.py

(`--noconftest`: tests/conftest.py imports JAX, and the JAX package does
not run on the card). Add `-k` to pick one case.
"""

from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none. Its first use
    compiles every CUDA source of the port, one nvcc each, all at once
    (each would otherwise build alone at its first launch); later uses
    find them built."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: runs on the card")
    from satdump_tpu_torch.ops.cuda import _build
    _build.build()
    return "cuda"


def kernels(*names):
    """The kernel wrappers of ops/cuda by name (each counts its
    `launches`)."""
    from satdump_tpu_torch.ops.cuda.gardner import gardner_walk
    from satdump_tpu_torch.ops.cuda.mm_clock import mm_walk
    from satdump_tpu_torch.ops.cuda.probe import affine_probe
    from satdump_tpu_torch.ops.cuda.resample import resample_arith_grid
    from satdump_tpu_torch.ops.cuda.resample_strip import resample_strip
    from satdump_tpu_torch.ops.cuda.sample_walk import (agc_walk, costas_walk,
                                                        pll_walk)
    from satdump_tpu_torch.ops.cuda.turbo_bcjr import turbo_bcjr
    from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
    from satdump_tpu_torch.ops.cuda.viterbi_block import (
        viterbi_block_acs, viterbi_block_traceback)
    every = {k.__name__: k for k in (
        viterbi_re, resample_arith_grid, agc_walk, pll_walk, costas_walk,
        mm_walk, turbo_bcjr, viterbi_block_acs, viterbi_block_traceback,
        gardner_walk, resample_strip, affine_probe)}
    return tuple(every[n] for n in names)


def counted(fn, names):
    """fn() with the launch count of each wrapper in `names` set to 0
    just before and read just after: (fn's result, {name: launches})."""
    ks = kernels(*names)
    torch.cuda.synchronize()
    for k in ks:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in ks}


def assert_launched(launches: dict, names=None, label: str = "") -> None:
    """Each of `names` (default: every counted one) launched at least once,
    so that no pass fell back to a plain version unseen."""
    names = list(launches) if names is None else list(names)
    missing = [n for n in names if not launches.get(n)]
    assert not missing, f"{label}: {missing} never launched: {launches}"


def sass(name: str) -> str:
    """`cuobjdump -sass` of csrc/<name>.cu's built library."""
    from satdump_tpu_torch.ops.cuda import _build
    from satdump_tpu_torch.tools.sass_chain import cuobjdump_sass
    _build.build([name])
    return cuobjdump_sass(_build._target(name))
