"""SPK (NAIF DAF) planetary/spacecraft ephemeris reader.

The reference vendors calceph + SuperNOVAS for Horizons-grade positions
(src-core/init.cpp:154-160), consumed by deep-space pipelines
(Chandrayaan, Juice, TGO, ...). This is a clean-room NumPy reader for the
public NAIF formats:

* DAF container (daf.req): 1024-byte records; file record with ND/NI,
  forward/backward summary-record pointers, binary format id; summary /
  name record pairs chained via NEXT pointers.
* SPK segments (spk.req) of type 2 (Chebyshev position) and type 3
  (Chebyshev position+velocity): fixed-size logical records of Chebyshev
  coefficients with a [INIT, INTLEN, RSIZE, N] directory at the segment
  end.

Times are TDB seconds past J2000. `SPK.position(target, center, et)`
chains segments (e.g. Moon->EMB->SSB) automatically when needed.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

RECLEN = 1024


class SPKSegment:
    def __init__(self, target: int, center: int, frame: int, dtype: int,
                 start_et: float, end_et: float, start_i: int, end_i: int):
        self.target = target
        self.center = center
        self.frame = frame
        self.dtype = dtype
        self.start_et = start_et
        self.end_et = end_et
        self.start_i = start_i          # 1-based word addresses
        self.end_i = end_i


class SPK:
    """Parsed SPK file; data kept as a flat float64 word array."""

    def __init__(self, data: bytes):
        self._raw = data
        locidw = data[:8].decode("ascii", "replace")
        if not locidw.startswith("DAF/SPK"):
            raise ValueError(f"not an SPK file: {locidw!r}")
        # binary format: little-endian assumed (LTL-IEEE); big-endian files
        # get byteswapped
        fmt = data[88:96].decode("ascii", "replace")
        self._bo = "<" if "LTL" in fmt or fmt.strip("\0 ") == "" else ">"
        nd, ni = struct.unpack(self._bo + "ii", data[8:16])
        fward, bward, free = struct.unpack(self._bo + "iii", data[76:88])
        if nd != 2 or ni != 6:
            raise ValueError(f"unexpected DAF ND/NI {nd}/{ni} for SPK")
        self.words = np.frombuffer(data, self._bo + "f8").copy()
        self.segments: List[SPKSegment] = []
        rec = fward
        ss = nd + (ni + 1) // 2          # summary size in doubles
        while rec > 0:
            base = (rec - 1) * RECLEN
            nxt, _prev, nsum = struct.unpack(
                self._bo + "ddd", data[base: base + 24])
            for i in range(int(nsum)):
                off = base + 24 + i * ss * 8
                start_et, end_et = struct.unpack(
                    self._bo + "dd", data[off: off + 16])
                ints = struct.unpack(self._bo + "6i",
                                     data[off + 16: off + 40])
                target, center, frame, dtype, si, ei = ints
                self.segments.append(SPKSegment(
                    target, center, frame, dtype, start_et, end_et, si, ei))
            rec = int(nxt)

    @classmethod
    def load(cls, path: str) -> "SPK":
        with open(path, "rb") as f:
            return cls(f.read())

    # -- evaluation ---------------------------------------------------------
    def _find(self, target: int, center: Optional[int], et: float
              ) -> Optional[SPKSegment]:
        for s in self.segments:
            if s.target == target and (center is None or s.center == center) \
                    and s.start_et <= et <= s.end_et:
                return s
        return None

    def _eval_cheby(self, seg: SPKSegment, et: float) -> np.ndarray:
        """-> position km (3,) for type 2/3 segments (spk.req)."""
        if seg.dtype not in (2, 3):
            raise NotImplementedError(f"SPK type {seg.dtype}")
        w = self.words
        # directory: last 4 doubles of the segment
        init, intlen, rsize, n = w[seg.end_i - 4: seg.end_i]
        rsize, n = int(rsize), int(n)
        idx = min(int((et - init) // intlen), n - 1)
        rec0 = seg.start_i - 1 + idx * rsize
        rec = w[rec0: rec0 + rsize]
        mid, radius = rec[0], rec[1]
        ncoef = (rsize - 2) // (3 if seg.dtype == 2 else 6)
        x = (et - mid) / radius
        # Chebyshev series sum a_k T_k(x) via Clenshaw: b_k = a_k +
        # 2x b_{k+1} - b_{k+2}; value = b_0 - x b_1 (SPK does not halve a_0)
        pos = np.empty(3)
        for c in range(3):
            coef = rec[2 + c * ncoef: 2 + (c + 1) * ncoef]
            b0 = b1 = 0.0
            for a in coef[::-1]:
                b0, b1 = 2 * x * b0 - b1 + a, b0
            pos[c] = b0 - x * b1
        return pos

    def position(self, target: int, center: int, et: float) -> np.ndarray:
        """Position of `target` relative to `center` in km at TDB `et`,
        chaining through intermediate centers (e.g. 301 -> 3 -> 0)."""
        def chain_to_ssb(body: int) -> Tuple[List[SPKSegment], int]:
            segs = []
            cur = body
            while cur != 0:
                s = self._find(cur, None, et)
                if s is None:
                    break
                segs.append(s)
                cur = s.center
            return segs, cur

        t_segs, t_root = chain_to_ssb(target)
        c_segs, c_root = chain_to_ssb(center)
        if target == center:
            return np.zeros(3)
        pos = np.zeros(3)
        for s in t_segs:
            pos += self._eval_cheby(s, et)
        for s in c_segs:
            pos -= self._eval_cheby(s, et)
        if not t_segs and target != 0:
            raise KeyError(f"no SPK segment covers body {target} at {et}")
        return pos


# ---------------------------------------------------------------------------
# Writer (test fixture / TX side): emits a minimal valid type-2 SPK
# ---------------------------------------------------------------------------
def write_spk_type2(path: str, segments: List[dict]) -> None:
    """segments: [{target, center, frame, init, intlen, coeffs (N,3,ncoef)}]
    Chebyshev radius per record = intlen/2, mids at init+(i+0.5)*intlen."""
    # data area layout: word addresses are 1-based doubles over the file
    word_chunks: List[np.ndarray] = []
    summaries = []
    # first data word starts at record 3 (after file record + one summary
    # record [+ one name record]) -> compute below once counts are known
    n_seg = len(segments)
    # records: 1 file, 2 summary, 3 name, 4.. data
    data_start_word = 3 * (RECLEN // 8) + 1     # 1-based
    cur = data_start_word
    for s in segments:
        coeffs = np.asarray(s["coeffs"], np.float64)   # (N, 3, ncoef)
        n, _, ncoef = coeffs.shape
        rsize = 2 + 3 * ncoef
        init, intlen = float(s["init"]), float(s["intlen"])
        words = []
        for i in range(n):
            mid = init + (i + 0.5) * intlen
            rec = np.concatenate([[mid, intlen / 2.0],
                                  coeffs[i].reshape(-1)])
            words.append(rec)
        dirw = np.array([init, intlen, rsize, n], np.float64)
        seg_words = np.concatenate(words + [dirw])
        start_i = cur
        end_i = cur + len(seg_words) - 1
        cur = end_i + 1
        word_chunks.append(seg_words)
        summaries.append((init, init + n * intlen, s["target"], s["center"],
                          s.get("frame", 1), 2, start_i, end_i))

    out = bytearray(3 * RECLEN)
    out[0:8] = b"DAF/SPK "
    struct.pack_into("<ii", out, 8, 2, 6)
    out[16:76] = b"satdump_tpu spk".ljust(60)
    struct.pack_into("<iii", out, 76, 2, 2, cur)   # fward, bward, free
    out[88:96] = b"LTL-IEEE"
    # FTP validation string (daf.req) — optional for our reader
    # summary record (record 2)
    base = RECLEN
    struct.pack_into("<ddd", out, base, 0.0, 0.0, float(n_seg))
    for i, (et0, et1, tgt, cen, frm, dt, si, ei) in enumerate(summaries):
        off = base + 24 + i * 40
        struct.pack_into("<dd", out, off, et0, et1)
        struct.pack_into("<6i", out, off + 16, tgt, cen, frm, dt, si, ei)
    # name record (record 3) left as spaces
    out[2 * RECLEN: 3 * RECLEN] = b" " * RECLEN
    data = np.concatenate(word_chunks) if word_chunks else np.zeros(0)
    pad = (-len(data)) % (RECLEN // 8)
    data = np.concatenate([data, np.zeros(pad)])
    with open(path, "wb") as f:
        f.write(bytes(out))
        f.write(data.astype("<f8").tobytes())
