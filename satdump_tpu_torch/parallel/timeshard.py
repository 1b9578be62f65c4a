"""Multi-device scale-out: channel × time-block sharding of sample streams
over the ranks of a torch.distributed process group — port of
satdump_tpu/parallel/timeshard.py.

The reference splits one contiguous stream over a 2D device mesh with the
axes

* ``ch`` — independent channels (trivially parallel), and
* ``t``  — consecutive time-blocks of ONE stream, with an overlap-save halo:
  each shard receives the tail of its predecessor, demodulates [halo | own
  block] so filter, AGC, carrier and timing estimators warm up inside the
  halo, and emits only the symbols whose position falls in the region it
  owns. Feedforward sync (ops/ffsync.py) makes this exact up to estimator
  noise; bit-exactness returns after FEC.

Here the mesh is a process group: one rank a (ch, t) cell, rank = ch · n_t
+ t, and one sub-group a ch row for the collectives along t (every rank
creates every group, in the same order). `run_sharded` is the single
controller (the reference's jit(shard_map(...)) call): it spawns one process
a rank, each runs `build_sharded_qpsk_step`'s step on its block, and it
gathers the results in the reference's (t, ch, ...) layout.

Transport. The backend is gloo, whatever the device: the compute stays on
each rank's device (``cuda:{rank % torch.cuda.device_count()}`` or the
CPU), and only the collectives' small tensors cross the host — the halo
tail, the successor's first symbol position, the seam-overlap tail and one
rotation a shard, a few kB a shard (`ShardedResult.stats["bytes_moved"]`).
gloo is the transport of this layer, not a fallback for something else.
NCCL (one rank a card, the tensors staying on the cards) waits for a
machine with several cards (ROADMAP).

Devices. `device_count(device)` is what `make_mesh` and psk_demod's
`multichip` read: ``torch.cuda.device_count()`` on cuda, 1 on the CPU,
unless `set_virtual_devices(n)` set n (the counterpart of XLA's forced host
device count: n ranks share the card, or the CPU).
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops import ffsync
from satdump_tpu_torch.ops.cuda import viterbi_block
from satdump_tpu_torch.ops.cuda.resample import resample_arith_grid
from satdump_tpu_torch.ops.fec import convolutional as cc
from satdump_tpu_torch.ops.firdes import (mm_interpolator_bank,
                                          root_raised_cosine)
from satdump_tpu_torch.utils.device import resolve_device, to_numpy

BACKEND = "gloo"
_virtual_devices: int | None = None
# the kernels a rank launches; their counts come back in the rank's stats
_RANK_KERNELS = (resample_arith_grid, viterbi_block.viterbi_block_acs,
                 viterbi_block.viterbi_block_traceback)


def set_virtual_devices(n: int | None) -> None:
    """Make `device_count()` report n devices (None: the real count)."""
    global _virtual_devices
    _virtual_devices = n


def device_count(device: str | torch.device | None = None) -> int:
    """The devices a mesh may use: the virtual count if set, else
    torch.cuda.device_count() on cuda and 1 on the CPU."""
    if _virtual_devices is not None:
        return _virtual_devices
    return torch.cuda.device_count() if resolve_device(device).type == "cuda" \
        else 1


class Mesh(NamedTuple):
    """A (ch, t) grid of ranks: rank = ch · n_t + t."""
    n_ch: int
    n_t: int

    @property
    def shape(self) -> Dict[str, int]:
        return {"ch": self.n_ch, "t": self.n_t}

    @property
    def size(self) -> int:
        return self.n_ch * self.n_t


def make_mesh(n_devices: int | None = None, n_ch: int | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """A (ch, t) mesh over the available devices. Channels get the smaller
    axis (most deployments decode a few channels at very high rates)."""
    n = n_devices or device_count(device)
    if n_ch is None:
        n_ch = 2 if n % 2 == 0 and n > 2 else 1
    return Mesh(n_ch, n // n_ch)


class Shard(NamedTuple):
    """One rank's place in the mesh, inside an initialized process group."""
    mesh: Mesh
    ch: int
    t: int
    group: object            # the ProcessGroup of this ch row


def join_mesh(mesh: Mesh, rank: int) -> Shard:
    """Create every ch row's sub-group (all ranks, in the same order) and
    return this rank's Shard."""
    groups = [dist.new_group([c * mesh.n_t + i for i in range(mesh.n_t)],
                             backend=BACKEND) for c in range(mesh.n_ch)]
    ch, t = divmod(rank, mesh.n_t)
    return Shard(mesh, ch, t, groups[ch])


def _exchange(shard: Shard, sends, recvs) -> int:
    """Point-to-point along the shard's row through the host: sends and
    recvs are lists of (t offset, tensor); returns the bytes sent. Received
    tensors are filled in place (CPU tensors)."""
    base = shard.ch * shard.mesh.n_t + shard.t
    ops = [dist.P2POp(dist.isend, x, base + dt, group=shard.group)
           for dt, x in sends]
    ops += [dist.P2POp(dist.irecv, x, base + dt, group=shard.group)
            for dt, x in recvs]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return sum(x.numel() * x.element_size() for _, x in sends)


def _host_c64(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x).cpu().contiguous()


def _halo_exchange_prev(x: torch.Tensor, halo: int, shard: Shard):
    """Give every t-shard the last `halo` samples of its predecessor (zeros
    for the first shard): (prev tail on x's device, bytes sent)."""
    nt, t = shard.mesh.n_t, shard.t
    buf = torch.zeros((halo, 2), dtype=torch.float32)
    sends = [(1, _host_c64(x[-halo:]))] if t < nt - 1 else []
    recvs = [(-1, buf)] if t > 0 else []
    sent = _exchange(shard, sends, recvs)
    return torch.view_as_complex(buf).to(x.device), sent


def build_sharded_qpsk_step(mesh: Mesh, *, sps: float, block: int,
                            halo: int = 8192, rrc_alpha: float = 0.5,
                            rrc_ntaps: int = 31, order: int = 4,
                            sub_phase: int = 1024, sub_timing: int = 2048
                            ) -> Callable:
    """Returns the per-rank step ``step(x, shard) -> (soft, valid, bits,
    bytes_sent)``: x the rank's (block,) complex64 block on its device;
    soft (2·cap,) int8 interleaved IQ softs at a fixed capacity, valid
    (cap,) bool, bits (cap - 8,) uint8 — the k=7 r=1/2 Viterbi decode (K3
    on the card) of the shard's softs; all on the rank's device.

    Seam correctness (as the reference):

    1. *Timing*: every shard fits the symbol grid on its own [halo | block]
       window; the grids of all shards coincide on the same global instants
       within estimator noise. The successor's first emitted position is
       sent backwards and each shard emits strictly below it (less half a
       symbol), so the union holds one symbol a grid point.
    2. *Carrier*: each shard's V&V phase leaves a 2π/M ambiguity. Both sides
       of a seam demodulate the overlap; the predecessor's phase-corrected
       tail goes forwards, their correlation gives the relative rotation on
       the constellation grid, and an all_gather along t plus a cumulative
       sum makes every shard's rotation consistent with shard 0.

    The symbols are picked on the arithmetic grid first + k·omega by K2
    (resample_arith_grid; its plain version on the CPU), then masked as the
    reference's ff_resample_at masks them.
    """
    rrc = root_raised_cosine(1.0, sps, 1.0, rrc_alpha, rrc_ntaps)
    bank_np = mm_interpolator_bank()
    ntaps = bank_np.shape[1]
    n_ext = halo + block
    cap = int(np.ceil(block / (sps * 0.99))) + 4
    D = float(ntaps)              # ownership boundary shift (samples)
    W = min(halo // 2, 4096)      # seam-overlap correlation window
    period = 2 * np.pi / order
    theta0 = float(np.pi / 4) if order == 4 else 0.0
    nbits = cap - 8
    nt = mesh.n_t
    nfft = 1 << int(np.ceil(np.log2(n_ext + rrc.shape[0] - 1)))
    f32 = torch.float32

    def demod(xi: torch.Tensor):
        dev = xi.device
        # block AGC + matched filter (overlap-save FFT over the window)
        g = 1.0 / xi.abs().mean().clamp_min(1e-12)
        xi = xi * g.to(xi.dtype)
        h = torch.fft.fft(torch.as_tensor(rrc, dtype=f32, device=dev), nfft)
        xf = torch.fft.ifft(torch.fft.fft(xi, nfft) * h)[:n_ext].to(
            torch.complex64)
        # carrier: per-shard CFO + V&V phase (ambiguity fixed at seams)
        f = ffsync.cfo_estimate(xf, order, suppress_nyquist_image=(sps < 2.1))
        xc = ffsync.cfo_correct(xf, f)
        ph_t, _ = ffsync.vv_phase_track(xc, order, sub_phase,
                                        const_rotation=theta0)
        xp = xc * torch.exp(-1j * ph_t).to(xc.dtype)
        # timing: global-consistent grid, own window [halo-D, halo+block-D)
        tau0, skew = ffsync.om_timing_fit(xp, sps, sub_timing)
        omega = sps * (1.0 + skew)
        k0 = torch.ceil((halo - D - tau0) / omega)
        first = tau0 + k0 * omega          # local pos of my first symbol
        pos = first + torch.arange(cap, dtype=f32, device=dev) * omega
        padded = torch.cat([torch.zeros(ntaps - 1, dtype=xp.dtype,
                                        device=dev), xp])
        bank = torch.as_tensor(bank_np, dtype=f32, device=dev)
        y = resample_arith_grid(padded, first.to(f32), omega.to(f32), bank,
                                out_cap=cap)
        v_interp = ffsync._valid_mask(pos, ntaps, n_ext)
        syms = torch.where(v_interp, y, torch.zeros_like(y))
        return syms, v_interp, pos, first, xp

    def step(x: torch.Tensor, shard: Shard):
        dev = x.device
        prev, sent = _halo_exchange_prev(x, halo, shard)
        syms, v_interp, pos, first, xp = demod(torch.cat([prev, x]))

        # seam symbol-count exactness: the successor's first symbol (global
        # coordinates) goes backwards; emit strictly below it, less half a
        # symbol (the two grids agree only to estimator noise). The last
        # shard emits to the stream's edge.
        t = shard.t
        g_off = float(t * block - halo)                # local -> global
        first_g = (first + g_off).to(f32).reshape(1).cpu()
        nxt_first = torch.zeros(1, dtype=f32)
        # seam phase: my ext[halo-W:halo] is the predecessor's ext[-W:]
        prev_tail = torch.zeros((W, 2), dtype=f32)
        sends, recvs = [], []
        if t > 0:
            sends.append((-1, first_g))
            recvs.append((-1, prev_tail))
        if t < nt - 1:
            sends.append((1, _host_c64(xp[-W:])))
            recvs.append((1, nxt_first))
        sent += _exchange(shard, sends, recvs)
        if t == nt - 1:
            cut_g = torch.tensor(nt * block - D, dtype=f32, device=dev)
        else:
            cut_g = nxt_first.to(dev)[0] - 0.5 * sps
        valid = v_interp & (pos + g_off < cut_g)

        prev_tail = torch.view_as_complex(prev_tail).to(dev)
        rel = (xp[halo - W: halo] * torch.conj(prev_tail)).sum()
        alpha = (torch.round(torch.angle(rel) / period) * period).to(f32)
        alphas = [torch.zeros(1, dtype=f32) for _ in range(nt)]
        dist.all_gather(alphas, alpha.reshape(1).cpu(), group=shard.group)
        sent += 4
        alphas[0] = torch.zeros(1, dtype=f32)         # shard 0 = reference
        rot = torch.cumsum(torch.cat(alphas), 0)[t].to(dev)
        syms = syms * torch.exp(-1j * rot).to(syms.dtype)

        # soft int8 (x100 interleaved IQ, module_psk_demod.cpp:203-213)
        soft = torch.stack([syms.real, syms.imag], dim=-1)
        soft = (soft * 100.0).clamp(-127, 127).to(torch.int8).reshape(-1)

        # the shard's Viterbi: pairs of softs -> bits (K3 on the card)
        u8 = (soft[: 2 * nbits].to(f32) + 128.0).reshape(1, nbits, 2)
        pm = torch.zeros((1, cc.NSTATES), dtype=f32, device=dev)
        pm, dec = cc.viterbi_acs(pm, u8)
        bits = cc.viterbi_traceback(pm, dec)[0]
        return soft, valid, bits, sent

    return step


def shard_input(x: np.ndarray, mesh: Mesh) -> np.ndarray:
    """A (CH, N) host array as the ranks read it: (CH, n_t, N / n_t), rank
    (ch, t) taking [ch, t]."""
    x = np.asarray(x, np.complex64)
    if x.ndim != 2 or x.shape[0] != mesh.n_ch or x.shape[1] % mesh.n_t:
        raise ValueError(f"shard_input: need ({mesh.n_ch}, k·{mesh.n_t}) "
                         f"samples, got {x.shape}")
    return x.reshape(mesh.n_ch, mesh.n_t, -1)


class ShardedResult(NamedTuple):
    soft: np.ndarray    # (t, ch, 2·cap) int8
    valid: np.ndarray   # (t, ch, cap) bool
    bits: np.ndarray    # (t, ch, cap - 8) uint8
    stats: dict


def _rank_main(rank: int, spec: dict) -> None:
    """One rank of run_sharded (a spawned process)."""
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    mesh = Mesh(*spec["mesh"])
    if spec["device"] == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)                    # the CUDA context
    else:
        dev = torch.device("cpu")
    tmp = Path(spec["tmp"])
    dist.init_process_group(BACKEND, init_method=f"file://{tmp / 'rdv'}",
                            world_size=mesh.size, rank=rank)
    try:
        shard = join_mesh(mesh, rank)
        blocks = np.load(tmp / "x.npy", mmap_mode="r")
        x = torch.from_numpy(np.array(blocks[shard.ch, shard.t])).to(dev)
        step = build_sharded_qpsk_step(mesh, **spec["step"])
        for k in _RANK_KERNELS:
            k.launches = 0
        dist.barrier()
        t1 = time.perf_counter()
        soft, valid, bits, sent = step(x, shard)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        np.savez(tmp / f"rank{rank}.npz", soft=to_numpy(soft),
                 valid=to_numpy(valid), bits=to_numpy(bits))
        stats = {"setup_s": t1 - t0, "step_s": t2 - t1, "bytes_sent": sent,
                 "launches": {k.__name__: k.launches for k in _RANK_KERNELS}}
        (tmp / f"rank{rank}.json").write_text(json.dumps(stats))
    finally:
        dist.destroy_process_group()


def run_sharded(x: np.ndarray, mesh: Mesh,
                device: str | torch.device | None = None,
                **step_kw) -> ShardedResult:
    """Run one sharded step over the (CH, N) stream x: one spawned process a
    rank of `mesh`, rendezvous through a file (no port), each rank on
    ``cuda:{rank % device_count}`` (or the CPU) with one intra-op thread.
    step_kw: build_sharded_qpsk_step's keywords (sps and block required).

    Returns the reference's layout, (t, ch, ...), and stats: the backend,
    the bytes the ranks sent through the host, the wall from the spawn to
    the ranks' exit, and per rank its set-up seconds (process start to
    ready: imports, CUDA context, rendezvous, input), its step's seconds
    and its kernels' launches. `run_sharded.last_stats` keeps the stats of
    the last call, for callers that reach it through a pipeline."""
    dev = resolve_device(device)
    import torch.multiprocessing as mp
    blocks = shard_input(x, mesh)
    with tempfile.TemporaryDirectory(prefix="timeshard-") as td:
        tmp = Path(td)
        np.save(tmp / "x.npy", blocks)
        spec = {"mesh": tuple(mesh), "device": dev.type, "tmp": str(tmp),
                "step": step_kw}
        t0 = time.perf_counter()
        mp.start_processes(_rank_main, args=(spec,), nprocs=mesh.size,
                           join=True, start_method="spawn")
        wall = time.perf_counter() - t0
        outs = [np.load(tmp / f"rank{r}.npz") for r in range(mesh.size)]
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(mesh.size)]

    def gather(key):
        return np.stack([np.stack([outs[c * mesh.n_t + t][key]
                                   for c in range(mesh.n_ch)])
                         for t in range(mesh.n_t)])

    stats = {"backend": BACKEND, "ranks": mesh.size, "device": dev.type,
             "bytes_moved": sum(r["bytes_sent"] for r in ranks),
             "spawn_to_exit_s": wall, "rank": ranks}
    logger.info(f"sharded step: mesh(ch={mesh.n_ch}, t={mesh.n_t}) on "
                f"{dev.type} over {BACKEND}, {stats['bytes_moved']} bytes "
                f"through the host, {wall:.2f} s spawn to exit")
    run_sharded.last_stats = stats
    return ShardedResult(gather("soft"), gather("valid"), gather("bits"),
                         stats)


run_sharded.last_stats = None
