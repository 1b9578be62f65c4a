"""The port's scale-out (parallel/timeshard.py on torch.distributed, gloo)
against the JAX package's shard_map over its 8-device CPU mesh
(tests/conftest.py).

Tolerances, those tests/test_torch_ffsync.py holds ff_psk_demod_block to
(symbol error at most 0.05, median under 1e-3): int8 softs (x100) at most 5
LSB apart with median 0; valid masks equal; the shards' Viterbi bits equal
to the JAX decoder's on the port's own softs; CADUs bit-exact.

The first shard of each stream has a halo of zeros, whose matched-filter
output is FFT round-off, different in the two packages (XLA's FFT against
torch's). Its V&V phases are angles of round-off, which has two effects
in both packages: (1) the phase the unwrap starts from, and so the whole
stream's rotation by a multiple of 90 degrees (every shard is stitched to
the first), is arbitrary; the softs are compared after the one rotation
that fits the channel (the deframer resolves it, as it does any QPSK
ambiguity); (2) the first sub_phase samples of signal are interpolated
against those phases, so their softs are arbitrary and left out. Each rank
runs torch with one intra-op thread.
"""

import jax
import numpy as np
import pytest
import torch

from satdump_tpu.ops.fec import convolutional as jcc
from satdump_tpu.parallel import (build_sharded_qpsk_step as jbuild_step,
                                  make_mesh as jmake_mesh,
                                  shard_input as jshard_input)
from satdump_tpu_torch import sim
from satdump_tpu_torch.core.exceptions import SatdumpError
from satdump_tpu_torch.parallel import dryrun, timeshard

SOFT_LSB = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Loops of small torch ops wait on intra-op thread pools that the
    other test workers keep busy: one thread in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,n_ch", [(n, c) for n in (1, 2, 3, 4, 6, 8)
                                    for c in (None, 1, 2) if c != 2 or n % 2
                                    == 0])
def test_make_mesh_shapes_match_jax(n, n_ch):
    assert timeshard.make_mesh(n, n_ch).shape == \
        dict(jmake_mesh(n, n_ch).shape)


def test_device_count_and_virtual_devices():
    assert timeshard.device_count("cpu") == 1
    timeshard.set_virtual_devices(8)
    try:
        assert timeshard.device_count("cpu") == 8
        assert timeshard.make_mesh().shape == {"ch": 2, "t": 4}
    finally:
        timeshard.set_virtual_devices(None)
    assert timeshard.make_mesh(device="cpu").shape == {"ch": 1, "t": 1}


def test_entry_points_default_to_cuda_and_raise_here():
    x = np.zeros((1, 2 * 8192), np.complex64)
    with pytest.raises(SatdumpError, match="cuda"):
        timeshard.run_sharded(x, timeshard.Mesh(1, 2), sps=2.0, block=8192)
    with pytest.raises(SatdumpError, match="cuda"):
        dryrun.dryrun_multichip(2)


def _streams(sps, n_t, block, seed):
    """Two QPSK channels of CADUs at `sps`, each n_t * block samples."""
    rng = np.random.default_rng(seed)
    out = []
    for ch in range(2):
        syms = sim.bits_to_qpsk_symbols(sim.encode_cadu_stream(
            sim.make_cadus(3, rng)))
        bb = sim.ChannelModel(snr_db=20.0, freq_offset=2e-4, phase=0.3 * ch,
                              seed=10 + ch).apply(
            sim.qpsk_modulate(syms, sps=sps))
        out.append(bb[: n_t * block])
    return np.stack(out).astype(np.complex64)


def _turned(soft, k):
    """Interleaved int8 IQ softs times j^k (exact: the softs are symmetric
    in [-127, 127])."""
    c = soft.astype(np.int16).reshape(-1, 2)
    for _ in range(k % 4):
        c = np.stack([-c[:, 1], c[:, 0]], axis=1)
    return c.reshape(-1)


def _rotation(got, ref) -> int:
    """The k for which got * j^k is nearest ref."""
    r = ref.astype(np.int16)
    return int(np.argmin([np.abs(_turned(got, k) - r).sum()
                          for k in range(4)]))


def _held(got, ref, lead, k):
    d = np.abs(_turned(got, k) - ref.astype(np.int16))[lead:]
    assert d.max() <= SOFT_LSB, d.max()
    assert np.median(d) == 0


@pytest.mark.parametrize("sps", [2.0, 2.2])
def test_sharded_step_matches_jax(sps):
    """The (ch=2, t=4) step on 8 gloo ranks at the dryrun's shapes against
    the JAX step on its 8-device mesh, on the same two streams."""
    kw = dict(dryrun.STEP_KW, sps=sps)
    mesh = timeshard.Mesh(2, 4)
    x = _streams(sps, mesh.n_t, kw["block"], seed=int(sps * 10))
    res = timeshard.run_sharded(x, mesh, "cpu", **kw)

    jmesh = jmake_mesh(8, n_ch=2)
    assert dict(jmesh.shape) == mesh.shape
    jsoft, jvalid, _ = jbuild_step(jmesh, **kw)(jshard_input(x, jmesh))
    jsoft, jvalid = np.asarray(jsoft), np.asarray(jvalid)
    assert res.soft.shape == jsoft.shape and res.soft.dtype == np.int8
    np.testing.assert_array_equal(res.valid, jvalid)
    assert res.valid.sum() > 0.9 * x.size / sps
    lead = 2 * int(np.ceil(kw["sub_phase"] / sps))
    for ch in range(mesh.n_ch):
        # one rotation for the whole channel, found on its second shard
        k = _rotation(res.soft[1, ch], jsoft[1, ch])
        for t in range(mesh.n_t):
            _held(res.soft[t, ch], jsoft[t, ch], lead if t == 0 else 0, k)
            # the shard's bits: the JAX decoder on the port's softs
            nbits = res.bits.shape[-1]
            u8 = res.soft[t, ch, : 2 * nbits].astype(np.float32) + 128.0
            pm, dec = jcc.viterbi_acs(jax.numpy.zeros((1, 64)),
                                      u8.reshape(1, nbits, 2))
            np.testing.assert_array_equal(
                res.bits[t, ch], np.asarray(jcc.viterbi_traceback(pm, dec))[0])
    st = res.stats
    assert st["backend"] == "gloo" and st["ranks"] == 8
    # through the host, per seam of a row: the halo tail and the seam
    # tail (complex64) and the first position; a rotation per shard
    halo, W = kw["halo"], min(kw["halo"] // 2, 4096)
    assert st["bytes_moved"] == mesh.n_ch * (
        (mesh.n_t - 1) * (8 * halo + 8 * W + 4) + 4 * mesh.n_t)
    assert all(r["launches"]["resample_arith_grid"] == 0
               for r in st["rank"])


def test_dryrun_runner_path_matches_jax(tmp_path):
    """dryrun_multichip(8) on the CPU: its step, then psk_demod with
    multichip on 8 ranks -> metop_ahrpt_decoder, 12 of 12 CADUs bit-exact;
    the .soft against the JAX runner's on the same baseband."""
    from satdump_tpu.io import write_baseband
    from satdump_tpu.pipeline.pipeline import Pipeline, PipelineStep
    from satdump_tpu.pipeline.runner import run_pipeline

    out = dryrun.dryrun_multichip(8, device="cpu")
    assert out["matched"] == 12 and out["mesh"] == (2, 4)
    cadus, bb = dryrun.runner_signal()
    np.testing.assert_array_equal(np.sort(out["cadus"], axis=0),
                                  np.sort(cadus, axis=0))

    write_baseband(tmp_path / "t.cf32", "cf32", bb)
    mp = dryrun.multichip_pipeline()
    pipe = Pipeline(id=mp.id, name=mp.name, parameters={}, steps=[
        PipelineStep(s.level, s.module_id, dict(s.parameters))
        for s in mp.steps])
    run_pipeline(pipe, str(tmp_path / "t.cf32"), str(tmp_path / "jax"),
                 user_params={"samplerate": 200_000.0})
    jsoft = np.fromfile(next((tmp_path / "jax").glob("*.soft")), np.int8)
    assert len(out["soft"]) == len(jsoft)
    # psk_demod's sharded step: sub_phase 1024 at sps 2
    lead = 2 * 1024 // 2
    k = _rotation(out["soft"][lead:], jsoft[lead:])
    _held(out["soft"], jsoft, lead, k)
