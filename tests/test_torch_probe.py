"""The port's toolchain probe (y = 2x + 1) against the JAX package's.

`affine_probe` on a CPU tensor runs the plain version of the CUDA kernel
csrc/probe_affine.cu. The oracle is the TPU probe's kernel body
(tools/pallas_smoke.py:6-16) run through `pl.pallas_call` in interpret mode
on the CPU, built here because importing tools/pallas_smoke.py would run
its TPU call. Tolerance: 0 (2x is exact, so both forms round once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from satdump_tpu_torch.ops.cuda.probe import affine_probe


def _pallas_probe(x: np.ndarray) -> np.ndarray:
    def kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0 + 1.0

    xj = jnp.asarray(x)
    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(xj.shape, xj.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(xj))


@pytest.mark.parametrize("kind", ["arange", "normal"])
def test_probe_matches_pallas_interpret(rng, kind):
    if kind == "arange":      # pallas_smoke.py's own input
        x = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    else:
        x = (rng.standard_normal((8, 128)) * 1e3).astype(np.float32)
    before = affine_probe.launches
    got = affine_probe(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _pallas_probe(x))
    assert got.dtype == np.float32 and got.shape == (8, 128)
    assert affine_probe.launches == before      # the CPU runs no kernel


@pytest.mark.parametrize("bad", ["float64", "non-contiguous", "meta"])
def test_probe_rejects_what_the_kernel_does_not_take(bad):
    x = {"float64": torch.zeros((8, 128), dtype=torch.float64),
         "non-contiguous": torch.zeros((128, 8)).T,
         "meta": torch.zeros((8, 128), device="meta")}[bad]
    with pytest.raises(ValueError):
        affine_probe(x)
