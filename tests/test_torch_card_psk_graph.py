"""psk_demod's feedforward block as one CUDA graph on the card
(ops/ffsync.py::FFBlockGraph, ops/cuda/graph.py): the replay equals the
eager chain bit for bit, block after block with the state carried; a whole
pass writes the eager chain's .soft bytes and replays once a block; two
demodulators with equal parameters share nothing; modules built one after
another hold no more memory; and the hand kernels that a replay runs are
counted and seen by the launch path once each, as the profiler records
them.

Every test here is marked `card` and skips where there is no CUDA card.
This file imports no JAX, nothing of the satdump_tpu package and no PIL; on
the card's host run it as tests/torch_card.py says.
"""

import time

import numpy as np
import pytest
import torch

from torch_card import card, counted  # noqa: F401

SEED = 20261018
BLOCK = 1 << 18

# name: (sps as up / down, constellation order, OQPSK, the symbol pick)
CASES = {
    "metop": ((18, 7), 4, False, "resample_arith_grid"),
    "fy3d": ((3, 1), 4, False, "resample_strip"),
    "oqpsk": ((2, 1), 4, True, "resample_strip"),
    "bpsk": ((18, 7), 2, False, "resample_arith_grid"),
}


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng([SEED, *key])


def _signal(rng, sps, order, oqpsk, n):
    """n samples of random symbols at sps = up / down through a channel
    with noise, a carrier offset and a phase."""
    from satdump_tpu_torch import sim
    up, down = sps
    nsym = int(n * down / up) + 64
    bits = rng.integers(0, 2, 2 * nsym).astype(np.uint8)
    syms = sim.bits_to_qpsk_symbols(bits)
    if order == 2:
        syms = np.sign(syms.real).astype(np.complex64)
    tx = sim.oqpsk_modulate(syms, up / down) if oqpsk \
        else sim.qpsk_modulate_rational(syms, up, down)
    chan = sim.ChannelModel(snr_db=15.0, freq_offset=1.5e-4, phase=0.3,
                            seed=int(rng.integers(1 << 30)))
    return chan.apply(tx)[:n].astype(np.complex64)


def _kw(sps, order, oqpsk):
    from satdump_tpu_torch.ops import firdes
    s = sps[0] / sps[1]
    return dict(order=order, sps=s, bank=firdes.mm_interpolator_bank(),
                rrc_taps=firdes.root_raised_cosine(1.0, s, 1.0, 0.5, 31),
                out_cap=int(np.ceil(BLOCK / (s * 0.99))) + 2, oqpsk=oqpsk)


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_graph_equals_the_eager_block_bit_for_bit(case, card):
    """12 consecutive blocks with their state carried: the replay's
    symbols, valid mask, SNR and state equal the eager chain's bit for
    bit. The pick kernel runs once a block inside the replay, counted:
    twice while the graph is built (the warm-up, and the capture that its
    first run makes), then once a replay."""
    from satdump_tpu_torch.ops import ffsync
    sps, order, oqpsk, pick = CASES[case]
    kw = _kw(sps, order, oqpsk)
    x = torch.from_numpy(_signal(_rng(1, list(CASES).index(case)), sps,
                                 order, oqpsk,
                                 12 * BLOCK)).to(card)
    ffsync.interp_tables(kw["bank"], kw["sps"], card)
    eager = ffsync.ff_clock_init(rrc_ntaps=31, device=card)
    state = ffsync.ff_clock_init(rrc_ntaps=31, device=card)
    graph, built = counted(lambda: ffsync.FFBlockGraph(state, BLOCK, **kw),
                           (pick,))
    assert built == {pick: 2}
    for b in range(12):
        blk = x[b * BLOCK: (b + 1) * BLOCK]
        eager, *want = ffsync.ff_psk_demod_block(eager, blk, **kw)
        got, ran = counted(lambda: [t.clone() for t in graph(blk)], (pick,))
        assert ran == {pick: 1}
        for name, g, w in zip(("syms", "valid", "snr"), got, want):
            assert torch.equal(g, w), (case, b, name)
        for name, g, w in zip(ffsync.FFClockState._fields, state, eager):
            assert torch.equal(g, w), (case, b, name)
        assert int(got[1].sum()) > 0.9 * BLOCK / kw["sps"]


def _module(tmp_path, name, sps):
    """A QPSK psk_demod at sps = up / down on the card, reading
    `in.cf32` and writing `<name>.soft` under tmp_path."""
    from satdump_tpu_torch.pipeline.modules.demod.psk import PSKDemodModule
    rate = 6e6
    return PSKDemodModule(str(tmp_path / "in.cf32"), str(tmp_path / name), {
        "samplerate": rate, "symbolrate": rate * sps[1] / sps[0],
        "constellation": "qpsk", "rrc_alpha": 0.5, "pll_bw": 0.003,
        "buffer_size": BLOCK, "torch_device": "cuda"})


@pytest.mark.card
@pytest.mark.parametrize("case", ["metop", "fy3d"])
def test_a_pass_writes_the_eager_soft_and_replays_once_a_block(
        case, card, tmp_path, monkeypatch):
    """A whole psk_demod pass over a recording (its last block padded)
    writes the same .soft bytes graphed as with the eager chain on the
    card, and `psk_demod.graph_replays` counts its blocks."""
    from satdump_tpu_torch.core import trace
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.ops import ffsync
    sps, order, oqpsk, _ = CASES[case]
    x = _signal(_rng(2, list(CASES).index(case)), sps, order, oqpsk,
                5 * BLOCK + 12345)
    write_baseband(tmp_path / "in.cf32", "cf32", x)
    out = {}
    for run in ("graph", "eager"):
        mod = _module(tmp_path, run, sps)
        trace.reset()
        trace.enable()
        try:
            mod.process()
        finally:
            trace.disable()
        got = trace.totals()
        assert (mod._graph is not None) == (run == "graph")
        blocks = got["spans"]["psk_demod.block"]["calls"]
        assert blocks == 6
        assert got["counters"].get("psk_demod.graph_replays", 0) == (
            blocks if run == "graph" else 0)
        out[run] = (tmp_path / f"{run}.soft").read_bytes()
        # the eager chain: the module as it was before the graph
        monkeypatch.setattr(ffsync, "FFBlockGraph", lambda *a, **k: None)
    trace.reset()
    assert len(out["graph"]) > 0.95 * 2 * len(x) / (sps[0] / sps[1])
    assert out["graph"] == out["eager"]


@pytest.mark.card
def test_interleaved_equal_demods_write_what_each_writes_alone(card,
                                                                 tmp_path):
    """Two MetOp demodulators in one process, fed block by block in turn
    with two different streams, each write what they write alone: each
    has its own graph, state and outputs."""
    sps = CASES["metop"][0]
    xs = [_signal(_rng(3, i), sps, 4, False, 4 * BLOCK) for i in range(2)]

    def blocks(mod, x, b):
        return mod.stream_work(x[b * BLOCK: (b + 1) * BLOCK]).tobytes()

    alone = []
    for i, x in enumerate(xs):
        mod = _module(tmp_path, f"alone{i}", sps)
        mod.stream_start()
        alone.append(b"".join(blocks(mod, x, b) for b in range(4)))
    mods = [_module(tmp_path, f"both{i}", sps) for i in range(2)]
    for mod in mods:
        mod.stream_start()
    both = [b"", b""]
    for b in range(4):
        for i in range(2):
            both[i] += blocks(mods[i], xs[i], b)
    assert both == alone
    assert alone[0] != alone[1]


@pytest.mark.card
def test_modules_built_one_after_another_reserve_no_more_memory(
        card, tmp_path):
    """A MetOp and a FY-3D module, built, run and dropped four times each
    in turn, as the offline runner builds one a pass: from the second
    round on, nothing more stays allocated or reserved on the card (the
    graphs share one side stream, whose cuBLAS workspace stays, and one
    memory pool)."""
    xs = {c: _signal(_rng(5, i), CASES[c][0], 4, False, 2 * BLOCK)
          for i, c in enumerate(("metop", "fy3d"))}
    held = []
    for _ in range(4):
        for c, x in xs.items():
            mod = _module(tmp_path, c, CASES[c][0])
            mod.stream_start()
            for b in range(2):
                mod.stream_work(x[b * BLOCK: (b + 1) * BLOCK])
            del mod
        torch.cuda.synchronize()
        held.append((torch.cuda.memory_allocated(),
                     torch.cuda.memory_reserved()))
    assert held[1] == held[2] == held[3], held


@pytest.mark.card
def test_replayed_picks_are_counted_and_seen_as_the_profiler_records_them(
        card, tmp_path, monkeypatch):
    """Under a profiler, as the benchmark's traced sessions profile a
    pass: a module built inside the session and 6 blocks. The device
    records of K2 equal the launches seen through the launch path
    (`_build.Kernel`) and its wrapper's count: 2 while building (the
    warm-up, and the capture that the graph's first run makes) and one a
    replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from satdump_tpu_torch.ops.cuda import _build
    sps = CASES["metop"][0]
    x = _signal(_rng(4), sps, 4, False, 6 * BLOCK)
    seen = []
    orig = _build.Kernel.__call__

    def hook(self, device_index, *args):
        if self.entry == "resample_arith":
            seen.append(args)
        return orig(self, device_index, *args)

    def run():
        mod = _module(tmp_path, "prof", sps)
        mod.stream_start()
        for b in range(6):
            mod.stream_work(x[b * BLOCK: (b + 1) * BLOCK])
    run()        # first use in this process outside the session
    monkeypatch.setattr(_build.Kernel, "__call__", hook)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the first kernel records of a session can go missing on the
        # card: lead launches take them, and idle time pads both ends
        lead = torch.zeros(1, device=card)
        for _ in range(32):
            lead.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.25)
        _, launched = counted(run, ("resample_arith_grid",))
        time.sleep(0.25)
    records = sum(1 for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and "resample_arith_kernel" in e.name())
    assert records == len(seen) == launched["resample_arith_grid"] == 8
