"""LDPC: normalized min-sum decoder (batched) + GF(2) tools.

Reference: src-core/common/codings/ldpc/ (generic min-sum decoder with a
SIMD-plugin registry, alist/sparse tools, CCSDS matrix construction). Here
one decoder covers all codes: messages live on the E edges of H and every
update is vectorized over (batch, edges) with lanes = frames, matching the
reference's many-frames-at-once SIMD layout.

Decoder math (normalized min-sum, the same algorithm as the reference's
plugins/simd_extensions/*/ldpc_decoder):
  v->c:  q_e = Lv[var_e] + sum_{e' at var_e} r_e' - r_e
  c->v:  r_e = alpha * prod_sign(q at check, excl e) * min|q| (excl e)
Per-check exclusive min/sign uses a padded dense (C, dc_max) layout so the
inner step is reshape/reduce, not scatter.

Counterpart of satdump_tpu/ops/fec/ldpc.py: the code structures and the
GF(2) encoder are host NumPy copies of it; the min-sum runs in torch ops on
the device it is given, one path on the CPU and on the card (no NumPy
fallback). The variable sums are gathers in a fixed order rather than a
scatter-add (whose atomics on the card add in a varying order): a
variable-major table of each variable's check slots, in the check-major
order in which XLA's scatter adds them, summed slot by slot from zero, then
added to the channel LLR. Every other step is exact (min, sign products,
alpha x +-1 x min), so the decoded bits equal the JAX package's bit for bit
and the card's equal the CPU's.

GF(2) encoding comes from a systematic generator derived from H by
Gaussian elimination (host NumPy, once per code).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from satdump_tpu_torch.utils.device import resolve_device, to_numpy


class LDPCCode(NamedTuple):
    """Preprocessed parity-check structure (host constants)."""
    n: int
    m: int                       # number of checks
    dc_max: int
    dv_max: int
    # dense check layout: (m, dc_max) var index per check slot, -1 = pad
    chk_vars: np.ndarray
    # for each edge in check-major order: its variable
    edge_var: np.ndarray         # (E,)
    edge_slot: np.ndarray        # (E,) position of the edge in chk_vars
    edge_chk: np.ndarray         # (E,)
    H: np.ndarray                # (m, n) uint8 dense


def code_from_dense(H: np.ndarray) -> LDPCCode:
    H = np.asarray(H, np.uint8)
    m, n = H.shape
    chk_lists = [np.nonzero(H[c])[0] for c in range(m)]
    dc_max = max(len(l) for l in chk_lists)
    dv_max = int(H.sum(0).max())
    chk_vars = np.full((m, dc_max), -1, np.int32)
    edge_var, edge_slot, edge_chk = [], [], []
    for c, l in enumerate(chk_lists):
        for s, v in enumerate(l):
            chk_vars[c, s] = v
            edge_var.append(v)
            edge_slot.append(s)
            edge_chk.append(c)
    return LDPCCode(n=n, m=m, dc_max=dc_max, dv_max=dv_max,
                    chk_vars=chk_vars,
                    edge_var=np.asarray(edge_var, np.int32),
                    edge_slot=np.asarray(edge_slot, np.int32),
                    edge_chk=np.asarray(edge_chk, np.int32), H=H)


def make_regular_code(n: int, dv: int, dc: int, seed: int = 0) -> LDPCCode:
    """Random regular Gallager construction (test/bench fixture)."""
    assert n * dv % dc == 0
    m = n * dv // dc
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.uint8)
    for layer in range(dv):
        perm = rng.permutation(n)
        for i, v in enumerate(perm):
            H[(layer * n + i) // dc % m, v] ^= 1
    return code_from_dense(H)


def var_slot_table(chk_vars: np.ndarray, n: int) -> np.ndarray:
    """(n, dv) int64: for each variable the flat dense slots (c * dc + s)
    that hold it, in check-major order, padded with m * dc (a zero slot
    appended to the messages)."""
    flat = np.asarray(chk_vars).reshape(-1)
    slots = np.flatnonzero(flat >= 0)
    var = flat[slots]
    order = np.argsort(var, kind="stable")       # check-major within a var
    counts = np.bincount(var, minlength=n)
    rank = np.arange(len(var)) - np.repeat(np.cumsum(counts) - counts, counts)
    table = np.full((n, max(int(counts.max()), 1)), flat.size, np.int64)
    table[var[order], rank] = slots[order]
    return table


def minsum_iters(llr: torch.Tensor, cv_safe: torch.Tensor,
                 valid: torch.Tensor, var_slots: torch.Tensor, iters: int,
                 alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """llr (B, n) float32 -> hard bits (B, n) uint8, parity-ok mask (B,),
    on llr's device (the JAX package's `_minsum_iters`)."""
    B, n = llr.shape
    m, dc = cv_safe.shape
    cv_flat = cv_safe.reshape(-1)
    inf = torch.tensor(float("inf"), dtype=llr.dtype, device=llr.device)
    zero = torch.zeros((), dtype=llr.dtype, device=llr.device)
    one = torch.ones((), dtype=llr.dtype, device=llr.device)
    total = llr
    r = torch.zeros((B, m, dc), dtype=llr.dtype, device=llr.device)
    pad = torch.zeros((B, 1), dtype=llr.dtype, device=llr.device)
    for _ in range(iters):
        q = torch.where(valid, total.index_select(1, cv_flat).view(B, m, dc)
                        - r, zero)
        aq = torch.where(valid, q.abs(), inf)
        sgn = torch.where(valid, torch.where(q < 0, -one, one), one)
        # exclusive min: min1/min2, masking the first argmin occurrence
        m1 = aq.amin(-1, keepdim=True)
        at_min = aq == m1
        is_min = at_min & (torch.cumsum(at_min, dim=-1) == 1)
        m2 = torch.where(is_min, inf, aq).amin(-1, keepdim=True)
        excl_min = torch.where(is_min, m2, m1)
        excl_sign = sgn.prod(-1, keepdim=True) * sgn
        r = torch.where(valid, alpha * excl_sign * excl_min, zero)
        # variable totals: each variable's slots summed in order from zero
        msgs = torch.cat([r.reshape(B, m * dc), pad], dim=1)
        acc = torch.zeros((B, n), dtype=llr.dtype, device=llr.device)
        for k in range(var_slots.shape[1]):
            acc = acc + msgs.index_select(1, var_slots[:, k])
        total = llr + acc
    bits = (total < 0).to(torch.uint8)
    # parity check: xor of bits over each check
    parity = (bits.index_select(1, cv_flat).view(B, m, dc) * valid
              ).sum(-1) % 2                                   # (B, m)
    return bits, (parity == 0).all(-1)


class MinSumDecoder:
    """Batched normalized min-sum LDPC decoder (lanes = frames)."""

    def __init__(self, code: LDPCCode, iters: int = 25, alpha: float = 0.75):
        self.code = code
        self.iters = iters
        self.alpha = alpha
        self._var_slots = var_slot_table(code.chk_vars, code.n)
        self._dev: Dict[torch.device, tuple] = {}

    def _tables(self, dev: torch.device):
        """(cv_safe, valid, var_slots) on `dev`, made once per device."""
        if dev not in self._dev:
            cv = torch.from_numpy(np.asarray(self.code.chk_vars, np.int64))
            self._dev[dev] = (cv.clamp_min(0).to(dev), (cv >= 0).to(dev),
                              torch.from_numpy(np.ascontiguousarray(
                                  self._var_slots.T)).to(dev).T)
        return self._dev[dev]

    def decode_tensor(self, llr: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """llr (B, n) float32 on its device -> (bits (B, n) uint8, ok (B,)
        bool) on that device."""
        return minsum_iters(llr, *self._tables(llr.device), self.iters,
                            self.alpha)

    def decode(self, llr: np.ndarray, device: str | torch.device | None = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """llr (B, n) float (positive = bit 0, like the reference's soft
        convention after sign flip), decoded on `device` (default cuda).
        Returns (bits (B, n) uint8, ok (B,))."""
        dev = resolve_device(device)
        llr_d = torch.from_numpy(np.asarray(llr, np.float32)).to(dev)
        bits, ok = self.decode_tensor(llr_d)
        return to_numpy(bits).astype(np.uint8), to_numpy(ok).astype(bool)


# ---------------------------------------------------------------------------
# GF(2) helpers: systematic generator from H (host, once per code)
# ---------------------------------------------------------------------------
def gf2_row_reduce(H: np.ndarray) -> Tuple[np.ndarray, list]:
    """Row-reduce H over GF(2). Returns (reduced H, pivot column list)."""
    H = H.copy().astype(np.uint8)
    m, n = H.shape
    pivots = []
    r = 0
    for c in range(n):
        if r >= m:
            break
        rows = np.nonzero(H[r:, c])[0]
        if rows.size == 0:
            continue
        pr = r + rows[0]
        if pr != r:
            H[[r, pr]] = H[[pr, r]]
        mask = H[:, c].copy()
        mask[r] = 0
        H[mask == 1] ^= H[r]
        pivots.append(c)
        r += 1
    return H, pivots


class SystematicEncoder:
    """Encode k-bit messages into n-bit codewords of the code defined by H.
    Message bits occupy the non-pivot columns; parity = solved pivots."""

    def __init__(self, code: LDPCCode):
        Hr, pivots = gf2_row_reduce(code.H)
        self.n = code.n
        self.pivots = np.asarray(pivots)
        self.free = np.asarray([c for c in range(code.n) if c not in set(pivots)])
        self.k = len(self.free)
        # parity[p] = sum over free columns of Hr[row(p), free] * msg
        rows = {c: r for r, c in enumerate(pivots)}
        self.P = np.stack([Hr[rows[c]][self.free] for c in pivots]) \
            if len(pivots) else np.zeros((0, self.k), np.uint8)

    def encode(self, msg: np.ndarray) -> np.ndarray:
        """msg (..., k) bits -> codeword (..., n) bits."""
        msg = np.asarray(msg, np.uint8)
        cw = np.zeros(msg.shape[:-1] + (self.n,), np.uint8)
        cw[..., self.free] = msg
        parity = (msg @ self.P.T) % 2
        cw[..., self.pivots] = parity
        return cw
