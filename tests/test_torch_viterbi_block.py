"""The port's block Viterbi (the plain version of the CUDA kernel K3) and
its streaming decoder against the JAX package's, on the CPU.

Tolerance: none. The plain ACS does the reference's float operations in its
order (|s - 255e| summed, pm + bm, the strict `cand_b < cand_a`, min, then
pm - min(pm) with renorm), and the traceback starts at argmin's lowest
state, so bits, final path metrics and decisions are identical, for
integer and non-integer softs, with ties, renorm on and off, B > 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops.fec import convolutional as jcc
from satdump_tpu_torch.ops.cuda import viterbi_block as vb
from satdump_tpu_torch.ops.fec import convolutional as tcc
from satdump_tpu_torch.utils import state as st


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Loops of small torch ops wait on intra-op thread pools that the
    other test workers keep busy: one thread in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _softs(rng, B, T, kind):
    bits = rng.integers(0, 2, (B, T)).astype(np.uint8)
    enc = jcc.conv_encode_batch(bits).astype(np.float32)
    if kind == "integer":
        s = np.where(enc > 0, 200.0, 55.0) + rng.integers(-60, 61, enc.shape)
    elif kind == "ties":
        # few distinct levels: equal candidates at most steps
        s = rng.choice([0.0, 128.0, 255.0], enc.shape)
    else:
        s = np.where(enc > 0, 220.0, 35.0) + rng.normal(0, 45.0, enc.shape)
    return np.clip(s, 0, 255).astype(np.float32).reshape(B, T, 2)


@pytest.mark.parametrize("kind", ["integer", "non-integer", "ties"])
@pytest.mark.parametrize("B,renorm", [(1, True), (3, True), (4, False)])
def test_plain_acs_traceback_match_jax(rng, kind, B, renorm):
    soft = _softs(rng, B, 300, kind)
    pm0 = rng.integers(0, 40, (B, 64)).astype(np.float32)
    jpm, jdec = jcc.viterbi_acs(jnp.asarray(pm0), jnp.asarray(soft),
                                renorm=renorm)
    jbits = jcc.viterbi_traceback(jpm, jdec)
    tpm, tdec = tcc.viterbi_acs(torch.from_numpy(pm0), torch.from_numpy(soft),
                                renorm=renorm)
    assert tdec.shape == (B, 300) and tdec.dtype == torch.int64
    np.testing.assert_array_equal(tpm.numpy(), np.asarray(jpm))
    np.testing.assert_array_equal(tcc.unpack_decisions(tdec).numpy(),
                                  np.asarray(jdec))
    bits = tcc.viterbi_traceback(tpm, tdec)
    assert bits.dtype == torch.uint8
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))


@pytest.mark.parametrize("row_steps", [1, 64, 300 * 3])
def test_plain_acs_packs_in_chunks(rng, monkeypatch, row_steps):
    """The plain ACS packs its decisions a few steps at a time (a step, 21
    steps with a partial last chunk, the whole block): the words equal the
    JAX decisions wherever the chunks end."""
    monkeypatch.setattr(tcc, "_PACK_ROW_STEPS", row_steps)
    soft = _softs(rng, 3, 300, "non-integer")
    pm0 = np.zeros((3, 64), np.float32)
    jpm, jdec = jcc.viterbi_acs(jnp.asarray(pm0), jnp.asarray(soft))
    tpm, tdec = tcc.viterbi_acs(torch.from_numpy(pm0), torch.from_numpy(soft))
    np.testing.assert_array_equal(tpm.numpy(), np.asarray(jpm))
    np.testing.assert_array_equal(tcc.unpack_decisions(tdec).numpy(),
                                  np.asarray(jdec))


@pytest.mark.parametrize("kind", ["integer", "non-integer", "ties"])
def test_plain_decode_block_matches_jax(rng, kind):
    soft = _softs(rng, 2, 700, kind)
    jb, jp = jcc.viterbi_decode_block(jnp.asarray(soft))
    tb, tp = tcc.viterbi_decode_block(torch.from_numpy(soft))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # a (T, 2) input is one row
    tb1, _ = tcc.viterbi_decode_block(torch.from_numpy(soft[0]))
    np.testing.assert_array_equal(tb1.numpy()[0], np.asarray(jb)[0])


def test_traceback_ties_take_lowest_state():
    """Every end metric equal: the traceback starts at state 0."""
    dec = torch.zeros((1, 5), dtype=torch.int64)
    bits = tcc.viterbi_traceback(torch.zeros((1, 64)), dec)
    ref = jcc.viterbi_traceback(jnp.zeros((1, 64)),
                                jnp.zeros((5, 1, 64), jnp.bool_))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref))


def test_pack_unpack_roundtrip(rng):
    dec = torch.from_numpy(rng.integers(0, 2, (9, 3, 64)).astype(bool))
    words = tcc.pack_decisions(dec)
    assert words.shape == (3, 9)
    assert torch.equal(tcc.unpack_decisions(words), dec)
    # the decision of state 2m + c is bit 32c + m; state 63 is the sign bit
    one = torch.zeros((1, 1, 64), dtype=torch.bool)
    one[0, 0, 63] = True
    assert int(tcc.pack_decisions(one)) == -(1 << 63)
    one[0, 0, 63], one[0, 0, 2] = False, True
    assert int(tcc.pack_decisions(one)) == 1 << 1


def _stream_soft(rng, n):
    bits = rng.integers(0, 2, n).astype(np.uint8)
    enc = jcc.conv_encode_batch(bits)
    soft = enc.astype(np.float32) * 255.0
    flips = rng.choice(len(enc), size=len(enc) // 30, replace=False)
    soft[flips] = 255.0 - soft[flips]
    return bits, soft.reshape(-1, 2)


def test_stream_viterbi_continuous(rng):
    """The counterpart of tests/test_fec.py::test_stream_viterbi_continuous:
    a stream decoded in 1024-pair calls equals the bits sent delayed by
    D = 96, and each call's output equals the JAX class's."""
    bits, pairs = _stream_soft(rng, 4096)
    sv = tcc.StreamViterbi(batch=1, traceback=96, device="cpu")
    jsv = jcc.StreamViterbi(batch=1, traceback=96)
    outs = []
    for i in range(0, len(pairs), 1024):
        chunk = pairs[None, i:i + 1024]
        got = sv.decode(torch.from_numpy(chunk))
        np.testing.assert_array_equal(got, jsv.decode(jnp.asarray(chunk)))
        outs.append(got)
    dec = np.concatenate([o[0] for o in outs])
    assert np.count_nonzero(dec[96:] != bits[:-96]) == 0
    np.testing.assert_array_equal(sv.pm.numpy(), np.asarray(jsv.pm))


def test_stream_viterbi_batch_and_odd_calls(rng):
    """B = 2 rows, calls shorter than the traceback depth."""
    rows = [_stream_soft(rng, 1000)[1] for _ in range(2)]
    pairs = np.stack(rows)
    sv = tcc.StreamViterbi(batch=2, traceback=96, device="cpu")
    jsv = jcc.StreamViterbi(batch=2, traceback=96)
    for lo, hi in ((0, 40), (40, 377), (377, 1000)):
        chunk = pairs[:, lo:hi]
        np.testing.assert_array_equal(sv.decode(chunk),
                                      jsv.decode(jnp.asarray(chunk)))


def test_viterbi_init_and_state_conversion(rng):
    js = jcc.viterbi_init(batch=3, traceback=20)
    ts = tcc.viterbi_init(batch=3, traceback=20, device="cpu")
    got = st.viterbi_state_to_numpy(ts)
    np.testing.assert_array_equal(got["pm"], np.asarray(js.pm))
    np.testing.assert_array_equal(got["decisions"], np.asarray(js.decisions))
    # a state from the reference's arrays, and back
    pm = rng.normal(0, 50, (3, 64)).astype(np.float32)
    dec = rng.integers(0, 2, (20, 3, 64)).astype(bool)
    s = st.viterbi_state_from_numpy(pm, dec, device="cpu")
    assert s.decisions.shape == (3, 20) and s.decisions.dtype == torch.int64
    back = st.viterbi_state_to_numpy(s)
    np.testing.assert_array_equal(back["pm"], pm)
    np.testing.assert_array_equal(back["decisions"], dec)
    # a traceback through the converted decisions equals the reference's
    np.testing.assert_array_equal(
        tcc.viterbi_traceback(s.pm, s.decisions).numpy(),
        np.asarray(jcc.viterbi_traceback(jnp.asarray(pm), jnp.asarray(dec))))


class _CudaLike:
    """Stands in for a CUDA tensor on a machine without CUDA."""

    def __init__(self, shape, dtype):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.ndim = len(shape)
        self.device = torch.device("cuda")

    def contiguous(self):
        return self

    def data_ptr(self):
        return 0


def test_kernel_wrappers_raise_without_fallback(monkeypatch):
    """A CUDA tensor goes to K3 (here its build raises: no nvcc), never to
    the plain loop; a device that is neither cuda nor cpu is refused."""
    from satdump_tpu_torch.ops.cuda import _build

    class FellBack(Exception):
        pass

    def no_fallback(*a, **k):
        raise FellBack("fell back to the plain version")

    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(tcc, "_acs_plain", no_fallback)
    monkeypatch.setattr(tcc, "_traceback_plain", no_fallback)
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: _CudaLike(
        a[0], k.get("dtype")))
    vb.viterbi_block_acs.launches = vb.viterbi_block_traceback.launches = 0
    with pytest.raises(_build.KernelBuildError):
        tcc.viterbi_acs(_CudaLike((2, 64), torch.float32),
                        _CudaLike((2, 100, 2), torch.float32))
    with pytest.raises(_build.KernelBuildError):
        tcc.viterbi_traceback(_CudaLike((2, 64), torch.float32),
                              _CudaLike((2, 100), torch.int64))
    assert vb.viterbi_block_acs.launches == 0
    assert vb.viterbi_block_traceback.launches == 0
    monkeypatch.undo()
    meta = torch.zeros((1, 10, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tcc.viterbi_acs(torch.zeros((1, 64), device="meta"), meta)
    with pytest.raises(ValueError, match="unsupported device"):
        vb.viterbi_block_acs(torch.zeros((1, 64)), torch.zeros((1, 10, 2)))
    with pytest.raises(ValueError, match="unsupported device"):
        vb.viterbi_block_traceback(torch.zeros((1, 64)),
                                   torch.zeros((1, 10), dtype=torch.int64))
