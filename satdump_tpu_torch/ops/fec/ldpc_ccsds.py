"""CCSDS 131.0-B LDPC code constructions: AR4JA (rates 1/2, 2/3, 4/5 at
block sizes k=1024/4096/16384) and the C2 rate-7/8 (8176,7154) code.

Reference behavior: src-core/common/codings/ldpc/make_ccsds.cpp (itself a
port of the public ldpc-toolbox ccsds.rs). A host NumPy copy of
satdump_tpu/ops/fec/ldpc_ccsds.py; the min-sum decode runs in torch on the
device `decode_frames` is given. The THETA_K / PHI_K permutation
tables and the C2 circulant offsets are public constants from CCSDS
131.0-B-3 tables 7-3/7-4 and 7-2.

The constructions here emit connection sets directly (XOR-toggled, since
AR4JA's Pi_k permutation sums can overlap identity entries) and build the
decoder's dense-check layout without materializing H — the 16384-block
codes would need a ~1 GB dense matrix.

Framing contract (matches ccsds_ldpc.cpp decode()):
- AR4JA: the last M codeword positions are punctured (never transmitted);
  the transmitted frame is the first n-M positions. RX appends M zero LLRs.
- C2: the (8176,7154) code is shortened by 18 leading fill zeros and padded
  with 2 trailing fill bits: TX frame is 8160 bits whose first 8158 carry
  codeword positions 18..8175. RX inserts the 18 fill positions as strong
  zero LLRs (known bits — stronger than the reference's 0-LLR erasures) and
  ignores the final 2 pad bits.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.fec.ldpc import LDPCCode, MinSumDecoder

# CCSDS 131.0-B table 7-3/7-4 theta_k (k = 1..26)
THETA_K = np.array([3, 0, 1, 2, 2, 3, 0, 1, 0, 1, 2, 0, 2, 3, 0, 1, 2, 0,
                    1, 2, 0, 1, 2, 1, 2, 3], np.int64)

# CCSDS 131.0-B table 7-3/7-4 phi_k(j, M): PHI[j][k-1][log2(M)-7]
PHI_K = np.array([
    [[1, 59, 16, 160, 108, 226, 1148], [22, 18, 103, 241, 126, 618, 2032],
     [0, 52, 105, 185, 238, 404, 249], [26, 23, 0, 251, 481, 32, 1807],
     [0, 11, 50, 209, 96, 912, 485], [10, 7, 29, 103, 28, 950, 1044],
     [5, 22, 115, 90, 59, 534, 717], [18, 25, 30, 184, 225, 63, 873],
     [3, 27, 92, 248, 323, 971, 364], [22, 30, 78, 12, 28, 304, 1926],
     [3, 43, 70, 111, 386, 409, 1241], [8, 14, 66, 66, 305, 708, 1769],
     [25, 46, 39, 173, 34, 719, 532], [25, 62, 84, 42, 510, 176, 768],
     [2, 44, 79, 157, 147, 743, 1138], [27, 12, 70, 174, 199, 759, 965],
     [7, 38, 29, 104, 347, 674, 141], [7, 47, 32, 144, 391, 958, 1527],
     [15, 1, 45, 43, 165, 984, 505], [10, 52, 113, 181, 414, 11, 1312],
     [4, 61, 86, 250, 97, 413, 1840], [19, 10, 1, 202, 158, 925, 709],
     [7, 55, 42, 68, 86, 687, 1427], [9, 7, 118, 177, 168, 752, 989],
     [26, 12, 33, 170, 506, 867, 1925], [17, 2, 126, 89, 489, 323, 270]],
    [[0, 0, 0, 0, 0, 0, 0], [27, 32, 53, 182, 375, 767, 1822],
     [30, 21, 74, 249, 436, 227, 203], [28, 36, 45, 65, 350, 247, 882],
     [7, 30, 47, 70, 260, 284, 1989], [1, 29, 0, 141, 84, 370, 957],
     [8, 44, 59, 237, 318, 482, 1705], [20, 29, 102, 77, 382, 273, 1083],
     [26, 39, 25, 55, 169, 886, 1072], [24, 14, 3, 12, 213, 634, 354],
     [4, 22, 88, 227, 67, 762, 1942], [12, 15, 65, 42, 313, 184, 446],
     [23, 48, 62, 52, 242, 696, 1456], [15, 55, 68, 243, 188, 413, 1940],
     [15, 39, 91, 179, 1, 854, 1660], [22, 11, 70, 250, 306, 544, 1661],
     [31, 1, 115, 247, 397, 864, 587], [3, 50, 31, 164, 80, 82, 708],
     [29, 40, 121, 17, 33, 1009, 1466], [21, 62, 45, 31, 7, 437, 433],
     [2, 27, 56, 149, 447, 36, 1345], [5, 38, 54, 105, 336, 562, 867],
     [11, 40, 108, 183, 424, 816, 1551], [26, 15, 14, 153, 134, 452, 2041],
     [9, 11, 30, 177, 152, 290, 1383], [17, 18, 116, 19, 492, 778, 1790]],
    [[0, 0, 0, 0, 0, 0, 0], [12, 46, 8, 35, 219, 254, 318],
     [30, 45, 119, 167, 16, 790, 494], [18, 27, 89, 214, 263, 642, 1467],
     [10, 48, 31, 84, 415, 248, 757], [16, 37, 122, 206, 403, 899, 1085],
     [13, 41, 1, 122, 184, 328, 1630], [9, 13, 69, 67, 279, 518, 64],
     [7, 9, 92, 147, 198, 477, 689], [15, 49, 47, 54, 307, 404, 1300],
     [16, 36, 11, 23, 432, 698, 148], [18, 10, 31, 93, 240, 160, 777],
     [4, 11, 19, 20, 454, 497, 1431], [23, 18, 66, 197, 294, 100, 659],
     [5, 54, 49, 46, 479, 518, 352], [3, 40, 81, 162, 289, 92, 1177],
     [29, 27, 96, 101, 373, 464, 836], [11, 35, 38, 76, 104, 592, 1572],
     [4, 25, 83, 78, 141, 198, 348], [8, 46, 42, 253, 270, 856, 1040],
     [2, 24, 58, 124, 439, 235, 779], [11, 33, 24, 143, 333, 134, 476],
     [11, 18, 25, 63, 399, 542, 191], [3, 37, 92, 41, 14, 545, 1393],
     [15, 35, 38, 214, 277, 777, 1752], [13, 21, 120, 70, 412, 483, 1627]],
    [[0, 0, 0, 0, 0, 0, 0], [13, 44, 35, 162, 312, 285, 1189],
     [19, 51, 97, 7, 503, 554, 458], [14, 12, 112, 31, 388, 809, 460],
     [15, 15, 64, 164, 48, 185, 1039], [20, 12, 93, 11, 7, 49, 1000],
     [17, 4, 99, 237, 185, 101, 1265], [4, 7, 94, 125, 328, 82, 1223],
     [4, 2, 103, 133, 254, 898, 874], [11, 30, 91, 99, 202, 627, 1292],
     [17, 53, 3, 105, 285, 154, 1491], [20, 23, 6, 17, 11, 65, 631],
     [8, 29, 39, 97, 168, 81, 464], [22, 37, 113, 91, 127, 823, 461],
     [19, 42, 92, 211, 8, 50, 844], [15, 48, 119, 128, 437, 413, 392],
     [5, 4, 74, 82, 475, 462, 922], [21, 10, 73, 115, 85, 175, 256],
     [17, 18, 116, 248, 419, 715, 1986], [9, 56, 31, 62, 459, 537, 19],
     [20, 9, 127, 26, 468, 722, 266], [18, 11, 98, 140, 209, 37, 471],
     [31, 23, 23, 121, 311, 488, 1166], [13, 8, 38, 12, 211, 179, 1300],
     [2, 7, 18, 41, 510, 430, 1033], [18, 24, 62, 249, 320, 264, 1606]],
], np.int64)

# AR4JA submatrix size M per (rate, block size k) — CCSDS 131.0-B table 7-1
_AR4JA_M: Dict[Tuple[str, int], int] = {
    ("1/2", 1024): 512, ("2/3", 1024): 256, ("4/5", 1024): 128,
    ("1/2", 4096): 2048, ("2/3", 4096): 1024, ("4/5", 4096): 512,
    ("1/2", 16384): 8192, ("2/3", 16384): 4096, ("4/5", 16384): 2048,
}


def _pi(rate_k: np.ndarray, m_log2: int, k: int) -> np.ndarray:
    """CCSDS 131.0-B §7.4.2.4 permutation pi_k(i) for i = 0..M-1, vectorized."""
    m = 1 << m_log2
    i = np.arange(m)
    j = (4 * i) // m
    a = (THETA_K[k - 1] + j) & 3
    phi = PHI_K[j, k - 1, m_log2 - 7]
    b = (phi + i) & ((m >> 2) - 1)
    return (a << (m_log2 - 2)) + b


class _ConnSet:
    """XOR-toggled sparse connection accumulator."""

    def __init__(self) -> None:
        self.s: Set[Tuple[int, int]] = set()

    def toggle(self, rows, cols) -> None:
        for r, c in zip(np.atleast_1d(rows), np.atleast_1d(cols)):
            key = (int(r), int(c))
            if key in self.s:
                self.s.remove(key)
            else:
                self.s.add(key)


def code_from_connections(n: int, m: int,
                          conns: Set[Tuple[int, int]]) -> LDPCCode:
    """Build the decoder layout from a (row, col) connection set, no dense H."""
    rows = np.asarray([r for r, _ in conns], np.int64)
    cols = np.asarray([c for _, c in conns], np.int64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    counts = np.bincount(rows, minlength=m)
    dc_max = int(counts.max())
    dv_max = int(np.bincount(cols, minlength=n).max())
    chk_vars = np.full((m, dc_max), -1, np.int32)
    slot = np.concatenate([np.arange(c) for c in counts]) if len(rows) else \
        np.zeros(0, np.int64)
    chk_vars[rows, slot] = cols
    return LDPCCode(n=n, m=m, dc_max=dc_max, dv_max=dv_max, chk_vars=chk_vars,
                    edge_var=cols.astype(np.int32),
                    edge_slot=slot.astype(np.int32),
                    edge_chk=rows.astype(np.int32), H=None)


@lru_cache(maxsize=None)
def make_ar4ja(rate: str, block: int) -> Tuple[LDPCCode, int]:
    """AR4JA parity-check structure. Returns (code, M). Codeword layout per
    make_ccsds.cpp: [extra info columns | 5M-column rate-1/2 core], the last
    M columns punctured."""
    if (rate, block) not in _AR4JA_M:
        raise ValueError(f"unsupported AR4JA rate/block {rate}/{block}")
    M = _AR4JA_M[(rate, block)]
    m_log2 = int(M).bit_length() - 1
    extra_blocks = {"1/2": 0, "2/3": 2, "4/5": 6}[rate]
    ec = M * extra_blocks
    n = ec + 5 * M
    cs = _ConnSet()
    i = np.arange(M)

    def pi(k):
        return _pi(i, m_log2, k)

    # H_1/2 core (block rows 0..2 over the last 5 column blocks)
    cs.toggle(i, ec + 2 * M + i)                     # (0,2) = I
    cs.toggle(i, ec + 4 * M + i)                     # (0,4) = I + Pi1
    cs.toggle(i, ec + 4 * M + pi(1))
    cs.toggle(M + i, ec + i)                          # (1,0) = I
    cs.toggle(M + i, ec + M + i)                      # (1,1) = I
    cs.toggle(M + i, ec + 3 * M + i)                  # (1,3) = I
    cs.toggle(M + i, ec + 4 * M + pi(2))              # (1,4) = Pi2+Pi3+Pi4
    cs.toggle(M + i, ec + 4 * M + pi(3))
    cs.toggle(M + i, ec + 4 * M + pi(4))
    cs.toggle(2 * M + i, ec + i)                      # (2,0) = I
    cs.toggle(2 * M + i, ec + M + pi(5))              # (2,1) = Pi5+Pi6
    cs.toggle(2 * M + i, ec + M + pi(6))
    cs.toggle(2 * M + i, ec + 3 * M + pi(7))          # (2,3) = Pi7+Pi8
    cs.toggle(2 * M + i, ec + 3 * M + pi(8))
    cs.toggle(2 * M + i, ec + 4 * M + i)              # (2,4) = I

    if rate != "1/2":
        ec23 = 0 if rate == "2/3" else 4 * M
        cs.toggle(M + i, ec23 + pi(9))                # (1,0) = Pi9+Pi10+Pi11
        cs.toggle(M + i, ec23 + pi(10))
        cs.toggle(M + i, ec23 + pi(11))
        cs.toggle(M + i, ec23 + M + i)                # (1,1) = I
        cs.toggle(2 * M + i, ec23 + i)                # (2,0) = I
        cs.toggle(2 * M + i, ec23 + M + pi(12))       # (2,1) = Pi12+Pi13+Pi14
        cs.toggle(2 * M + i, ec23 + M + pi(13))
        cs.toggle(2 * M + i, ec23 + M + pi(14))

    if rate == "4/5":
        cs.toggle(M + i, pi(21))                      # (1,0) = Pi21+Pi22+Pi23
        cs.toggle(M + i, pi(22))
        cs.toggle(M + i, pi(23))
        cs.toggle(M + i, M + i)                       # (1,1) = I
        cs.toggle(M + i, 2 * M + pi(15))              # (1,2) = Pi15+Pi16+Pi17
        cs.toggle(M + i, 2 * M + pi(16))
        cs.toggle(M + i, 2 * M + pi(17))
        cs.toggle(M + i, 3 * M + i)                   # (1,3) = I
        cs.toggle(2 * M + i, i)                       # (2,0) = I
        cs.toggle(2 * M + i, M + pi(24))              # (2,1) = Pi24+Pi25+Pi26
        cs.toggle(2 * M + i, M + pi(25))
        cs.toggle(2 * M + i, M + pi(26))
        cs.toggle(2 * M + i, 2 * M + i)               # (2,2) = I
        cs.toggle(2 * M + i, 3 * M + pi(18))          # (2,3) = Pi18+Pi19+Pi20
        cs.toggle(2 * M + i, 3 * M + pi(19))
        cs.toggle(2 * M + i, 3 * M + pi(20))

    return code_from_connections(n, 3 * M, cs.s), M


# C2 (8176,7154) circulant offsets — CCSDS 131.0-B table 7-2
_C2_CIRC = np.array([
    [[0, 176], [12, 239], [0, 352], [24, 431], [0, 392], [151, 409],
     [0, 351], [9, 359], [0, 307], [53, 329], [0, 207], [18, 281],
     [0, 399], [202, 457], [0, 247], [36, 261]],
    [[99, 471], [130, 473], [198, 435], [260, 478], [215, 420], [282, 481],
     [48, 396], [193, 445], [273, 430], [302, 451], [96, 379], [191, 386],
     [244, 467], [364, 470], [51, 382], [192, 414]],
], np.int64)

C2_N, C2_M, C2_SB = 8176, 1022, 511
C2_FILL_FRONT = 18        # shortened leading zeros (known-0 at RX)
C2_FRAME_BITS = 8160      # transmitted block incl. 2 trailing pad bits
C2_DATA_BITS = 7136       # 7154 - 18 fill


@lru_cache(maxsize=None)
def make_c2() -> LDPCCode:
    """The C2 rate-7/8 (8176,7154) quasi-cyclic code: 2x16 grid of 511x511
    circulants, two 1s per circulant row."""
    row = np.arange(C2_SB)
    rows_l, cols_l = [], []
    for sy in range(2):
        for sx in range(16):
            for off in _C2_CIRC[sy, sx]:
                rows_l.append(sy * C2_SB + row)
                cols_l.append(sx * C2_SB + (off + row) % C2_SB)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    return code_from_connections(C2_N, C2_M, set(zip(rows.tolist(),
                                                     cols.tolist())))


# ---------------------------------------------------------------------------
# Packed-GF2 systematic encoder (fast enough for C2 and all AR4JA sizes)
# ---------------------------------------------------------------------------
class PackedGF2Encoder:
    """Systematic encoder from the sparse H via packed-uint64 Gaussian
    elimination. Pivot columns are chosen RIGHT-to-left so parity lands in
    the trailing columns and the message occupies the leading (info)
    positions — the CCSDS systematic layout for both AR4JA and C2.

    Setup is O(m) pivot column reductions over packed rows: fast for the
    C2 code and all 1024-block AR4JA codes (the test/TX fixtures); the
    16384-block codes are decode-only (tests use the zero codeword)."""

    def __init__(self, code: LDPCCode):
        m, n = code.m, code.n
        words = (n + 63) // 64
        Hp = np.zeros((m, words), np.uint64)
        e_chk, e_var = code.edge_chk, code.edge_var
        w_idx = (e_var // 64).astype(np.int64)
        b_idx = (63 - e_var % 64).astype(np.uint64)
        np.bitwise_xor.at(Hp, (e_chk.astype(np.int64), w_idx),
                          np.uint64(1) << b_idx)
        pivots: List[int] = []
        r = 0
        for c in range(n - 1, -1, -1):
            if r >= m:
                break
            w, b = c // 64, np.uint64(63 - c % 64)
            col = (Hp[r:, w] >> b) & np.uint64(1)
            nz = np.nonzero(col)[0]
            if nz.size == 0:
                continue
            pr = r + nz[0]
            if pr != r:
                Hp[[r, pr]] = Hp[[pr, r]]
            hits = np.nonzero((Hp[:, w] >> b) & np.uint64(1))[0]
            hits = hits[hits != r]
            Hp[hits] ^= Hp[r]
            pivots.append(c)
            r += 1
        self.rank = len(pivots)
        self.n = n
        self.pivots = np.asarray(pivots, np.int64)
        free_mask = np.ones(n, bool)
        free_mask[self.pivots] = False
        self.free = np.nonzero(free_mask)[0]
        self.k = len(self.free)
        # parity p = sum_f P[p,f] * msg_f (reduced rows at free columns)
        P = np.zeros((self.rank, self.k), np.uint8)
        for j, f in enumerate(self.free):
            w, b = f // 64, np.uint64(63 - f % 64)
            P[:, j] = ((Hp[: self.rank, w] >> b) & np.uint64(1)).astype(np.uint8)
        self.P = P.astype(np.int32)

    def encode(self, msg: np.ndarray) -> np.ndarray:
        """msg (..., k) -> codeword (..., n) with message on free columns."""
        msg = np.asarray(msg, np.uint8)
        cw = np.zeros(msg.shape[:-1] + (self.n,), np.uint8)
        cw[..., self.free] = msg
        cw[..., self.pivots] = ((msg.astype(np.int32) @ self.P.T) % 2
                                ).astype(np.uint8)
        return cw


# ---------------------------------------------------------------------------
# Framing helpers (the ccsds_ldpc.cpp decode() contract)
# ---------------------------------------------------------------------------
class CCSDSLDPC:
    """One CCSDS LDPC code: construction + framing + batched min-sum decode.
    Mirrors codings::ldpc::CCSDSLDPC (ccsds_ldpc.cpp) with lanes = frames."""

    def __init__(self, rate: str, block: int = 0, iters: int = 10):
        self.rate = rate
        self.iters = iters
        if rate == "7/8":
            self.code = make_c2()
            self.M = 0
            self.frame_bits = C2_FRAME_BITS
            self.codeword_bits = C2_N
            self.data_bits = C2_DATA_BITS
        else:
            self.code, self.M = make_ar4ja(rate, block)
            self.frame_bits = self.code.n - self.M
            self.codeword_bits = self.code.n
            self.data_bits = self.code.n - self.code.m  # = k (H full rank)
        self.dec = MinSumDecoder(self.code, iters=iters)

    def frames_to_llr(self, soft: np.ndarray) -> np.ndarray:
        """(B, frame_bits) int8 softs (positive = bit 1, receiver convention)
        -> (B, n) LLR floats (positive = bit 0)."""
        soft = np.asarray(soft, np.float32)
        B = soft.shape[0]
        llr = np.zeros((B, self.codeword_bits), np.float32)
        if self.rate == "7/8":
            llr[:, C2_FILL_FRONT:] = -soft[:, : C2_N - C2_FILL_FRONT]
            llr[:, :C2_FILL_FRONT] = 127.0  # shortened bits are known 0s
        else:
            llr[:, : self.frame_bits] = -soft
            # last M positions punctured: LLR 0 (unknown)
        return llr

    def decode_frames(self, soft: np.ndarray,
                      device: str | torch.device | None = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, frame_bits) int8 -> (bits (B, frame_bits) uint8, ok (B,)),
        decoded on `device` (default cuda)."""
        llr = self.frames_to_llr(soft)
        bits, ok = self.dec.decode(llr, device=device)
        if self.rate == "7/8":
            out = np.zeros((bits.shape[0], self.frame_bits), np.uint8)
            out[:, : C2_N - C2_FILL_FRONT] = bits[:, C2_FILL_FRONT:]
            return out, ok
        return bits[:, : self.frame_bits], ok

    def encoder(self) -> PackedGF2Encoder:
        return PackedGF2Encoder(self.code)

    def encode_frames(self, enc: PackedGF2Encoder,
                      data: np.ndarray) -> np.ndarray:
        """(B, data_bits) -> (B, frame_bits) channel bits. For C2, the 18
        leading fill zeros are prepended before encoding (shortening)."""
        data = np.asarray(data, np.uint8)
        if self.rate == "7/8":
            # 18 leading fill zeros; H has 2 dependent rows (rank 1020) so
            # 2 extra free positions exist in the parity region — zero them
            msg = np.concatenate(
                [np.zeros(data.shape[:-1] + (C2_FILL_FRONT,), np.uint8),
                 data,
                 np.zeros(data.shape[:-1] + (enc.k - C2_FILL_FRONT
                                             - data.shape[-1],), np.uint8)],
                axis=-1)
        else:
            msg = data
        assert msg.shape[-1] == enc.k, (msg.shape, enc.k)
        cw = enc.encode(msg)
        if self.rate == "7/8":
            out = np.zeros((cw.shape[0], self.frame_bits), np.uint8)
            out[:, : C2_N - C2_FILL_FRONT] = cw[:, C2_FILL_FRONT:]
            return out
        return cw[:, : self.frame_bits]
