"""Fused device soft->CADU chain: Viterbi + NRZ-M + deframe + derand + RS
per chunk — port of satdump_tpu/ops/fec/cadu_chain.py.

Counterpart of the reference's decoder hot loop
(module_ccsds_conv_concat_decoder.cpp / module_metop_ahrpt_decoder.cpp:
read softs -> Viterbi -> deframer -> derand -> RS -> write CADU). The whole
chain stays on the device: the host uploads one int8 soft chunk and
downloads packed CADUs + stats.

Per stage:
* soft rotation (phase ambiguity fix): 2x2 rotation on IQ pairs;
* Viterbi k=7 r=1/2: register-exchange lanes — the CUDA kernel K1 on the
  card (ops/cuda/viterbi.py), its plain version on the CPU;
* NRZ-M: XOR with the 1-delayed stream (carried seam bit);
* deframing: ASM hamming distance at every bit offset, folded modulo the
  CADU length — the lock position is the residue with the most exact ASM
  hits (an inverted stream has distance 32-d). Frames are then one periodic
  slice, since a locked stream is exactly periodic;
* derandomization: XOR with the tiled CCSDS PN;
* RS(255,223/239): batched device decode (rs_device.py); on the card it
  is captured once a shape as a CUDA graph and replayed (`_GraphedRS`).

The host streams overlapping chunks (carry = last cadu+31 bits) so frames
straddling a seam are recovered in the next call; emitted frames are
deduplicated by absolute bit position.
"""

from __future__ import annotations

import threading
from typing import Tuple

import numpy as np
import torch

from satdump_tpu_torch.core import trace
from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
from satdump_tpu_torch.ops.fec import convolutional as cc
from satdump_tpu_torch.ops.fec.deframer import CCSDS_ASM, asm_bits
from satdump_tpu_torch.ops.fec.randomization import CCSDS_PN
from satdump_tpu_torch.ops.fec.rs_device import RSDevice
from satdump_tpu_torch.utils.device import resolve_device, to_numpy

SEG = 1024     # Viterbi lane segment (pairs)
HALO = 128     # Viterbi lane overlap / seam context (pairs)
I32 = torch.int32

# the card's RS decodes as CUDA graphs, by (device, k, dual, depth, shape),
# shared by every chain of a process
_RS_GRAPHS: dict = {}
_RS_GRAPHS_LOCK = threading.Lock()


def _conv_encode_dev(bits: torch.Tensor) -> torch.Tensor:
    """Device r=1/2 k=7 encoder: bits (N,) int32 -> (2N,) int32 channel bits
    (zero register history at index 0; callers prepend context bits)."""
    n = bits.shape[0]
    reg = torch.zeros((n,), dtype=I32, device=bits.device)
    for k in range(cc.K):
        sh = bits if k == 0 else torch.cat(
            [torch.zeros((k,), dtype=I32, device=bits.device), bits[:-k]])
        reg = reg | (sh << k)

    def par(v):
        v = v ^ (v >> 4)
        v = v ^ (v >> 2)
        v = v ^ (v >> 1)
        return v & 1

    e0 = par(reg & cc.POLYA)
    e1 = par(reg & cc.POLYB)
    return torch.stack([e0, e1], dim=-1).reshape(-1)


def _asm_distance(bits: torch.Tensor, pattern: np.ndarray) -> torch.Tensor:
    """Hamming distance of the 32-bit pattern at every offset: 32 shifted
    adds. bits: (N,) int32 0/1 -> (N-31,) int32."""
    m = len(pattern)
    nv = bits.shape[0] - m + 1
    dist = torch.zeros((nv,), dtype=I32, device=bits.device)
    for j in range(m):
        dist = dist + (bits[j: j + nv] ^ int(pattern[j]))
    return dist


class _GraphedRS:
    """`RSDevice.decode_interleaved` of one payload shape on the card,
    captured once as a CUDA graph and replayed. The Berlekamp-Massey loop
    issues ~1,000 small kernels a call; replayed, they are one launch, and
    the host no longer spends a chunk's time issuing them."""

    def __init__(self, rs: RSDevice, depth: int, shape):
        dev = rs.device
        self.rs = rs        # the graph reads its tables where they lie
        self.lock = threading.Lock()
        self.x = torch.zeros(shape, dtype=I32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):      # first use outside the capture
            rs.decode_interleaved(self.x, depth)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out, self.nerr = rs.decode_interleaved(self.x, depth)

    def __call__(self, data: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        with self.lock:
            self.x.copy_(data)
            self.graph.replay()
            return self.out.clone(), self.nerr.clone()


class CaduChain:
    """Builder for the fused device chain. Statics fixed at construction;
    per-call dynamics (rotation, carries) are tensor arguments."""

    def __init__(self, *, cadu_bits: int, chunk_pairs: int,
                 asm: int = CCSDS_ASM, nrzm: bool = False,
                 derand: bool = True, derand_after_rs: bool = False,
                 derand_from: int = 4, rs_i: int = 0, rs_k: int = 223,
                 rs_dual: bool = True, asm_thr: int = 6,
                 device: str | torch.device | None = None):
        self.device = dev = resolve_device(device)
        self.L = cadu_bits
        self.cadu_bytes = -(-cadu_bits // 8)
        self.chunk_pairs = int(np.ceil(chunk_pairs / SEG)) * SEG
        self.carry_bits = self.L + 31
        self.nrzm = nrzm
        self.derand = derand
        self.derand_after_rs = derand_after_rs
        self.derand_from = derand_from
        self.rs_i = rs_i
        self.asm_thr = asm_thr
        self.pattern = np.asarray(asm_bits(asm), np.int32)
        self._pattern_t = torch.as_tensor(self.pattern, device=dev)
        self.rs = RSDevice(k=rs_k, dual=rs_dual, device=dev) if rs_i else None
        # Viterbi runs over [soft ctx | chunk | erasure pad] so chunk-head
        # bits always have HALO pairs of real left context (seam exactness)
        self.vit_pairs = self.chunk_pairs + SEG
        N = self.carry_bits + self.chunk_pairs
        self.F = (N - 32) // self.L
        if derand:
            reps = -(-(self.cadu_bytes - derand_from) // 255)
            self.pn = np.tile(CCSDS_PN, reps)[: self.cadu_bytes - derand_from
                                              ].astype(np.int32)
            self._pn_t = torch.as_tensor(self.pn, device=dev)
        self._step = self._trace

    # ------------------------------------------------------------ device
    def _trace(self, pairs: torch.Tensor, soft_ctx: torch.Tensor,
               rot: torch.Tensor, swap: torch.Tensor,
               bit_carry: torch.Tensor, nrzm_carry: torch.Tensor,
               n_pairs: int):
        """pairs: (chunk_pairs, 2) int8 SIGNED softs (-127..127; zeros beyond
        n_pairs). soft_ctx: (HALO, 2) f32 — the previous chunk's trailing
        pairs (Viterbi left context at the seam). rot: (2,) f32 (c0, c1)
        with i' = c0 i + c1 q, q' = -c1 i + c0 q. swap: f32 0/1. bit_carry:
        (carry_bits,) int32 post-NRZM bits from the previous call.
        nrzm_carry: int32 last raw bit. n_pairs: valid-pair count (host
        int, 0 <= n_pairs <= chunk_pairs)."""
        dev = pairs.device
        if not 0 <= n_pairs <= self.chunk_pairs:
            raise ValueError(f"n_pairs {n_pairs} outside [0, "
                             f"{self.chunk_pairs}]")
        pairs = pairs.to(torch.float32)
        cat = torch.cat([soft_ctx, pairs])                # (HALO+chunk, 2)
        i0, q0 = cat[:, 0], cat[:, 1]
        i1 = (1.0 - swap) * i0 + swap * q0
        q1 = (1.0 - swap) * q0 + swap * i0
        c0, c1 = rot[0], rot[1]
        ir = c0 * i1 + c1 * q1
        qr = -c1 * i1 + c0 * q1
        u8 = torch.stack([ir, qr], dim=-1) + 128.0

        # mask beyond the valid count to erasures (128) and pad to the
        # SEG-multiple Viterbi width
        pk = torch.arange(HALO + self.chunk_pairs, device=dev)
        u8 = torch.where((pk < HALO + n_pairs)[:, None], u8,
                         torch.full_like(u8, 128.0))
        u8p = torch.cat([u8, torch.full((self.vit_pairs - u8.shape[0], 2),
                                        128.0, device=dev)])

        # K1: the CUDA kernel on the card, the plain decoder on the CPU
        raw = viterbi_re(u8p, seg=SEG, ovl=HALO).to(I32)[
            HALO: HALO + self.chunk_pairs]

        # re-encode BER over a centered window (lock health, ref
        # viterbi_1_2.cpp:105-122); mask erasures and invalid tail
        W = 2048
        w0 = self.chunk_pairs // 2
        ctx = 8
        reenc = _conv_encode_dev(raw[w0 - ctx: w0 + W])[2 * ctx:]
        rx = u8p.reshape(-1)[2 * (HALO + w0): 2 * (HALO + w0 + W)]
        hard = (rx > 127.5).to(I32)
        live = (rx != 128.0) & ((torch.arange(2 * W, device=dev) + 2 * w0)
                                < 2 * n_pairs)
        errs = torch.where(live, hard ^ reenc, 0).sum()
        tot = live.sum().clamp_min(1)
        ber = errs.to(torch.float32) / tot.to(torch.float32)

        bits = raw
        if self.nrzm:
            prev = torch.cat([nrzm_carry.reshape(1).to(I32), raw[:-1]])
            bits = raw ^ prev  # NRZ-M: change = 1 (differential.py)
        new_nrzm = raw[max(n_pairs - 1, 0)]
        # next call's soft context: the last HALO valid input pairs
        new_ctx = cat[n_pairs: n_pairs + HALO]
        pk = torch.arange(self.chunk_pairs, device=dev)

        # zero bits beyond the valid region, then prepend the carried seam
        bits = torch.where(pk < n_pairs, bits, 0)
        stream = torch.cat([bit_carry.to(I32), bits])
        N = stream.shape[0]

        dist = _asm_distance(stream, self.pattern)       # (N-31,)
        K = (N - 31) // self.L
        d2 = dist[: K * self.L].reshape(K, self.L)
        hits_n = (d2 == 0).to(I32).sum(dim=0)             # (L,)
        hits_i = (d2 == 32).to(I32).sum(dim=0)
        # torch.argmax takes the first index on ties, as jnp.argmax
        best_n = torch.argmax(hits_n)
        best_i = torch.argmax(hits_i)
        # indexing by a 0-dim card tensor reads the index on the host
        with trace.span("decoder.lock_peak", "wait"):
            inverted = hits_i[best_i] > hits_n[best_n]
        r = torch.where(inverted, best_i, best_n).to(I32)
        with trace.span("decoder.lock_peak", "wait"):
            nhits = torch.maximum(hits_n[best_n], hits_i[best_i])

        # periodic frame extraction: an index gather from r (a device scalar,
        # so no host sync); the zero pad keeps every index in range
        ext = torch.cat([stream, torch.zeros((self.L,), dtype=I32,
                                             device=dev)])
        span = torch.arange(self.F * self.L, device=dev)
        fr = ext[r.long() + span].reshape(self.F, self.L)
        fr = fr ^ inverted.to(I32)
        dpad = torch.cat([dist, torch.full((self.L + 32,), 32, dtype=I32,
                                           device=dev)])
        fdist = dpad[r.long() + span[:: self.L]]
        fdist = torch.where(inverted, 32 - fdist, fdist)

        # write the nominal ASM over the header (ref reset_frame), pack bytes
        fr[:, :32] = self._pattern_t[None, :]
        fbytes = torch.zeros((self.F, self.cadu_bytes), dtype=I32, device=dev)
        for k in range(8):
            fbytes = fbytes + (fr[:, k::8] << (7 - k))

        rs_errs = torch.zeros((self.F, max(self.rs_i, 1)), dtype=I32,
                              device=dev)
        if self.derand and not self.derand_after_rs:
            fbytes[:, self.derand_from:] ^= self._pn_t
        if self.rs is not None:
            payload = fbytes[:, 4: 4 + 255 * self.rs_i]
            corrected, rs_errs = self._rs_decode(payload)
            fbytes[:, 4: 4 + 255 * self.rs_i] = corrected
        if self.derand and self.derand_after_rs:
            fbytes[:, self.derand_from:] ^= self._pn_t

        # pack 4 bytes/int32 word (big-endian) for a compact fetch
        nw = -(-self.cadu_bytes // 4)
        padb = nw * 4 - self.cadu_bytes
        fb = torch.cat([fbytes, torch.zeros((self.F, padb), dtype=I32,
                                            device=dev)], dim=1) \
            if padb else fbytes
        words = fb.reshape(self.F, nw, 4)
        words = (words[..., 0] << 24) | (words[..., 1] << 16) \
            | (words[..., 2] << 8) | words[..., 3]

        # new carry: the last carry_bits VALID bits = stream[n_pairs :
        # n_pairs + carry_bits] (valid stream length is carry_bits + n_pairs)
        new_carry = stream[n_pairs: n_pairs + self.carry_bits]
        return (words, fdist, rs_errs, r, inverted.to(I32),
                nhits, new_carry, new_ctx, new_nrzm, ber)

    def _rs_decode(self, payload: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The interleaved RS decode: replayed from its CUDA graph on the
        card (captured at the first call of a shape), direct elsewhere."""
        if payload.device.type != "cuda":
            return self.rs.decode_interleaved(payload, self.rs_i)
        key = (str(payload.device), self.rs.k, self.rs.dual, self.rs_i,
               tuple(payload.shape))
        with _RS_GRAPHS_LOCK:
            graphed = _RS_GRAPHS.get(key)
            if graphed is None:
                graphed = _RS_GRAPHS[key] = _GraphedRS(self.rs, self.rs_i,
                                                       payload.shape)
        return graphed(payload)

    # ----------------------------------------------------------------- host
    def init_state(self):
        dev = self.device
        return dict(
            bit_carry=torch.zeros(self.carry_bits, dtype=I32, device=dev),
            soft_ctx=torch.zeros((HALO, 2), dtype=torch.float32, device=dev),
            nrzm_carry=torch.zeros((), dtype=I32, device=dev),
            abs_base=-self.carry_bits,   # absolute index of stream[0]
            last_emitted=-1,
        )

    _ROT = {0: (1.0, 0.0), 1: (0.0, 1.0), 2: (-1.0, 0.0), 3: (0.0, -1.0)}

    def work(self, state: dict, soft: np.ndarray, phase: int, iq_swap: bool
             ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """One chunk of signed int8 softs (interleaved IQ; length <=
        2*chunk_pairs, padded internally). Returns (cadus (F', bytes) uint8,
        rs_errs (F', rs_i), stats dict). Mutates `state`. Spans: the
        pad, copy and device chain (`decoder.chain`, its copies the wait
        `decoder.to_device`), the copies back (`decoder.to_host`), the
        unpacking and dedup on the host (`decoder.unpack`)."""
        dev = self.device
        with trace.span("decoder.chain"):
            soft = np.asarray(soft, np.int8)
            n_pairs = len(soft) // 2
            buf = np.zeros((self.chunk_pairs, 2), np.int8)
            buf.reshape(-1)[: n_pairs * 2] = np.where(
                soft[: n_pairs * 2] == -128, -127, soft[: n_pairs * 2])
            with trace.span("decoder.to_device", "wait"):
                rot = torch.tensor(self._ROT[phase], dtype=torch.float32,
                                   device=dev)
                swap = torch.tensor(1.0 if iq_swap else 0.0, device=dev)
                pairs = torch.from_numpy(buf).to(dev)
            (words, fdist, rs_errs, r, inv, nhits, new_carry, new_ctx,
             new_nrzm, ber) = \
                self._step(pairs, state["soft_ctx"], rot, swap,
                           state["bit_carry"], state["nrzm_carry"], n_pairs)
        state["bit_carry"] = new_carry
        state["soft_ctx"] = new_ctx
        state["nrzm_carry"] = new_nrzm
        with trace.span("decoder.to_host", "wait"):
            words = to_numpy(words)
            fdist = to_numpy(fdist)
            rs_errs = to_numpy(rs_errs)
            r = int(r)
            stats = dict(ber=float(ber), nhits=int(nhits),
                         inverted=bool(int(inv)))
        with trace.span("decoder.unpack", "host"):
            # unpack words -> bytes
            F = words.shape[0]
            by = np.empty((F, words.shape[1] * 4), np.uint8)
            by[:, 0::4] = (words >> 24) & 0xFF
            by[:, 1::4] = (words >> 16) & 0xFF
            by[:, 2::4] = (words >> 8) & 0xFF
            by[:, 3::4] = words & 0xFF
            by = by[:, : self.cadu_bytes]

            # absolute-position dedup + validity
            abs_start = state["abs_base"] + r + np.arange(F) * self.L
            abs_end = abs_start + self.L
            valid_end = state["abs_base"] + self.carry_bits + n_pairs
            keep = (fdist <= self.asm_thr) \
                & (abs_start > state["last_emitted"]) & (abs_end <= valid_end)
            if keep.any():
                state["last_emitted"] = int(abs_start[keep].max())
            state["abs_base"] += n_pairs
            return by[keep], rs_errs[keep], stats

    def flush(self, state: dict, phase: int = 0, iq_swap: bool = False
              ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Drain the seam carry: a frame that STARTS within the last
        cadu+31 bits of a chunk is deferred to the next call; when the
        stream ends exactly on a chunk boundary that next call never
        happens. One empty-input call recovers it."""
        return self.work(state, np.zeros(0, np.int8), phase, iq_swap)
