/* CCSDS 121.0-B adaptive entropy (Rice) decoder, szip-RAW compatible.
 *
 * Reference behavior: the vendored szip/libaec used by
 * plugins/goes_support/goes/hrit/module_goes_lrit_data_decoder.cpp:137
 * (SZ_BufftoBuffDecompress with SZ_RAW_OPTION_MASK — no szip header).
 * One call decodes one reference-sample interval (a GOES HRIT scanline):
 * blocks of J samples, each preceded by an option ID
 *   0 (+0) zero-block | 0 (+1) second-extension | 1..2^L-2 split k=id-1 |
 *   2^L-1 uncompressed,  L = 3 for n<=8, 4 for n<=16
 * followed by the coded mapped deltas; with preprocessing, the first sample
 * of the interval is a raw (unmapped) reference sample and each subsequent
 * sample restores via the CCSDS nearest-neighbour unmap
 *   theta = min(x - xmin, xmax - x)
 *   m <= 2*theta : x' = x + m/2 (even) | x - (m+1)/2 (odd)
 *   else         : x' = x + (m - theta)  if theta == x - xmin
 *                  x' = x - (m - theta)  otherwise
 *
 * Only the MSB-first, unsigned, preprocessed profile is implemented (the
 * GOES HRIT profile: AEC_DATA_MSB | AEC_DATA_PREPROCESS).
 */

#include <stddef.h>
#include <stdint.h>

typedef struct {
    const uint8_t *buf;
    size_t len;      /* bits available */
    size_t pos;      /* bit position */
} bitreader;

static inline int br_get(bitreader *br, int nbits, uint32_t *out) {
    uint32_t v = 0;
    if (br->pos + (size_t)nbits > br->len)
        return -1;
    for (int i = 0; i < nbits; i++) {
        size_t p = br->pos + (size_t)i;
        v = (v << 1) | ((br->buf[p >> 3] >> (7 - (p & 7))) & 1);
    }
    br->pos += (size_t)nbits;
    *out = v;
    return 0;
}

/* unary fundamental-sequence code: count zeros until a 1 */
static inline int br_fs(bitreader *br, uint32_t *out) {
    uint32_t v = 0;
    for (;;) {
        if (br->pos >= br->len)
            return -1;
        uint8_t bit = (br->buf[br->pos >> 3] >> (7 - (br->pos & 7))) & 1;
        br->pos++;
        if (bit) { *out = v; return 0; }
        if (++v > 1u << 20) return -1; /* runaway guard */
    }
}

static inline uint32_t unmap(uint32_t x, uint32_t m, uint32_t xmax) {
    uint32_t t_lo = x, t_hi = xmax - x;
    uint32_t theta = t_lo < t_hi ? t_lo : t_hi;
    if (m <= 2 * theta)
        return (m & 1) ? x - ((m + 1) >> 1) : x + (m >> 1);
    if (t_lo <= t_hi)
        return x + (m - theta);    /* theta = x - xmin: delta positive */
    return x - (m - theta);       /* theta = xmax - x: delta negative */
}

/* Decode one reference-sample interval from an open bitreader.
 * out: n_out decoded samples (uint32); n: bits per sample (<=32);
 * J: samples per block; returns 0 ok, <0 error. */
static int decode_interval(bitreader *brp, uint32_t *out,
                           int n_out, int n, int J, int preprocess) {
    if (n < 1 || n > 32 || J < 1 || J > 64 || n_out < 1)
        return -2;
    bitreader br = *brp;
    int id_len = n <= 8 ? 3 : (n <= 16 ? 4 : 5);
    uint32_t uncomp_id = (1u << id_len) - 1;
    uint32_t xmax = n == 32 ? 0xFFFFFFFFu : (1u << n) - 1;
    uint32_t mapped[64];
    uint32_t last = 0;
    int idx = 0;       /* samples emitted */
    int block_i = 0;   /* block index in this RSI */
    int zero_left = 0; /* pending zero blocks */

    while (idx < n_out) {
        int ref = preprocess && idx == 0;
        /* encoders pad the tail block to a full J samples; parse the whole
         * block, emit only what the scanline needs */
        int todo = J;
        int emit = n_out - idx < J ? n_out - idx : J;
        int start = 0;

        if (zero_left > 0) {
            for (int i = 0; i < todo; i++) mapped[i] = 0;
            zero_left--;
            goto restore;
        }

        uint32_t id;
        if (br_get(&br, id_len, &id) < 0) return -1;

        if (id == 0) {
            uint32_t ext;
            if (br_get(&br, 1, &ext) < 0) return -1;
            if (ref) {
                if (br_get(&br, (uint32_t)n, &mapped[0]) < 0) return -1;
                start = 1;
            }
            if (!ext) {
                /* zero block: FS gives run length; 5 = rest of segment */
                uint32_t fs;
                if (br_fs(&br, &fs) < 0) return -1;
                uint32_t zb = fs + 1;
                if (zb == 5) {
                    int seg_pos = block_i % 64;
                    zb = (uint32_t)(64 - seg_pos);
                } else if (zb > 5)
                    zb--;
                for (int i = start; i < todo; i++) mapped[i] = 0;
                zero_left = (int)zb - 1;
            } else {
                /* second extension: pairs via triangular mapping; with a
                 * reference sample the first code is a half pair (0, s1) */
                int i = start;
                while (i < todo) {
                    uint32_t m;
                    if (br_fs(&br, &m) < 0) return -1;
                    /* gamma = largest g with g(g+1)/2 <= m */
                    uint32_t g = 0;
                    while ((g + 1) * (g + 2) / 2 <= m) g++;
                    uint32_t b = m - g * (g + 1) / 2;
                    uint32_t a = g - b;
                    if (i == start && (todo - start) % 2 == 1) {
                        mapped[i++] = b; /* half pair */
                        if (a != 0) return -3;
                    } else {
                        mapped[i++] = a;
                        if (i < todo) mapped[i++] = b;
                    }
                }
            }
        } else if (id == uncomp_id) {
            for (int i = 0; i < todo; i++)
                if (br_get(&br, (uint32_t)n, &mapped[i]) < 0) return -1;
        } else {
            int k = (int)id - 1;
            if (ref) {
                if (br_get(&br, (uint32_t)n, &mapped[0]) < 0) return -1;
                start = 1;
            }
            for (int i = start; i < todo; i++)
                if (br_fs(&br, &mapped[i]) < 0) return -1;
            if (k > 0)
                for (int i = start; i < todo; i++) {
                    uint32_t lsb;
                    if (br_get(&br, k, &lsb) < 0) return -1;
                    mapped[i] = (mapped[i] << k) | lsb;
                }
        }

    restore:
        for (int i = 0; i < emit; i++) {
            uint32_t s;
            if (!preprocess)
                s = mapped[i];
            else if (idx + i == 0)
                s = mapped[i];           /* raw reference sample */
            else
                s = unmap(last, mapped[i], xmax);
            last = s;
            out[idx + i] = s;
        }
        idx += emit;
        block_i++;
    }
    *brp = br;
    return 0;
}

/* Decode one reference-sample interval (szip-RAW single-RSI surface, the
 * GOES HRIT scanline profile). */
int rice_decode_rsi(const uint8_t *in, size_t in_bytes, uint16_t *out,
                    int n_out, int n, int J, int preprocess) {
    uint32_t tmp[8192];
    if (n_out > 8192 || n > 16)
        return -2;
    bitreader br = {in, in_bytes * 8, 0};
    int rc = decode_interval(&br, tmp, n_out, n, J, preprocess);
    if (rc == 0)
        for (int i = 0; i < n_out; i++)
            out[i] = (uint16_t)tmp[i];
    return rc;
}

/* 32-bit samples (the JPSS OMPS profile: n=32, J=32, MSB|NN), multi-RSI. */
int rice_decode_stream32(const uint8_t *in, size_t in_bytes, uint32_t *out,
                         int n_out, int n, int J, int rsi, int preprocess) {
    if (rsi < 1)
        return -2;
    bitreader br = {in, in_bytes * 8, 0};
    int per = rsi * J;
    for (int off = 0; off < n_out; off += per) {
        int cnt = n_out - off < per ? n_out - off : per;
        int rc = decode_interval(&br, out + off, cnt, n, J, preprocess);
        if (rc < 0)
            return rc;
    }
    return 0;
}

/* Decode a multi-interval stream: a new reference sample every rsi blocks
 * (libaec semantics with AEC_DATA_PREPROCESS; bit-continuous between
 * intervals — the JPSS VIIRS profile: n=15, J=8, rsi=128). */
int rice_decode_stream(const uint8_t *in, size_t in_bytes, uint16_t *out,
                       int n_out, int n, int J, int rsi, int preprocess) {
    if (rsi < 1 || n > 16)
        return -2;
    bitreader br = {in, in_bytes * 8, 0};
    int per = rsi * J;
    uint32_t tmp[64];
    (void)tmp;
    for (int off = 0; off < n_out; off += per) {
        int cnt = n_out - off < per ? n_out - off : per;
        /* decode into a heap-free window: reuse out via widening copy */
        uint32_t buf32[16384];
        int done = 0;
        while (done < cnt) {
            int c = cnt - done < 16384 ? cnt - done : 16384;
            /* decode_interval must see the WHOLE interval at once for
             * reference-sample semantics; cap per to 16384 via rsi */
            c = cnt; /* intervals are rsi*J <= 16384 for all profiles */
            if (c > 16384)
                return -2;
            int rc = decode_interval(&br, buf32, c, n, J, preprocess);
            if (rc < 0)
                return rc;
            for (int i = 0; i < c; i++)
                out[off + done + i] = (uint16_t)buf32[i];
            done += c;
        }
    }
    return 0;
}
