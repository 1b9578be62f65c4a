/* Minimal baseline/extended-sequential JPEG decoder with 12-bit support,
 * single (grayscale) component.
 *
 * The reference vendors a 12-bit libjpeg build (src-core/libs/jpeg12,
 * image/jpeg12_utils.cpp) because GK-2A LRIT, FY-4 xRIT, DSCOVR EPIC and
 * MATS distribute 12-bit JPEG payloads that ordinary 8-bit JPEG libraries
 * (incl. PIL) refuse. This is a from-scratch decoder for exactly that
 * dataset class: SOF0/SOF1 (precision 8 or 12), one component, Huffman,
 * optional restart markers. Color/multi-component images return an error
 * so callers can fall back to a general library.
 *
 * API:
 *   long jpeg12_decode_gray(const uint8_t *data, size_t len,
 *                           uint16_t *out, size_t out_cap,
 *                           int *w, int *h, int *precision);
 *   returns 0 on success, <0 on parse errors.
 *
 * The PyTorch port's copy of satdump_tpu/native/jpeg12.c, hardened for
 * payloads that came over a radio link: every marker segment's body is
 * checked against its length before it is read, table selectors above 3
 * and Huffman tables whose codes overrun their symbols are refused, and a
 * magnitude category above 16 is a decode error (-11 .. -14). On a valid
 * stream it decodes exactly as the original does.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    const uint8_t *d;
    size_t n, i;
    uint32_t acc;
    int nacc;
    int marker_hit; /* hit a marker during entropy read */
} BR;

static int br_byte(BR *r) { /* entropy-coded byte with FF00 unstuffing */
    if (r->i >= r->n) return -1;
    uint8_t b = r->d[r->i];
    if (b == 0xFF) {
        if (r->i + 1 < r->n && r->d[r->i + 1] == 0x00) {
            r->i += 2;
            return 0xFF;
        }
        r->marker_hit = 1;
        return -1;
    }
    r->i++;
    return b;
}

static int br_bit(BR *r) {
    if (!r->nacc) {
        int b = br_byte(r);
        if (b < 0) return 0; /* pad with zeros at marker/end (spec F.2.2.5) */
        r->acc = (uint32_t)b;
        r->nacc = 8;
    }
    r->nacc--;
    return (r->acc >> r->nacc) & 1;
}

static int br_bits(BR *r, int n) {
    int v = 0;
    while (n--)
        v = (v << 1) | br_bit(r);
    return v;
}

/* canonical Huffman: decode one symbol by walking code lengths */
typedef struct {
    int mincode[17], maxcode[17], valptr[17];
    uint8_t vals[256];
} Huff;

static int huff_build(Huff *h, const uint8_t counts[16],
                      const uint8_t *vals, int nvals) {
    memcpy(h->vals, vals, nvals);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
        h->valptr[l] = k;
        h->mincode[l] = code;
        code += counts[l - 1];
        k += counts[l - 1];
        h->maxcode[l] = code - 1;
        if (!counts[l - 1]) h->maxcode[l] = -1;
        if (code > (1 << l)) return -14; /* more codes than l bits hold */
        code <<= 1;
    }
    return 0;
}

static int huff_decode(BR *r, const Huff *h) {
    int code = br_bit(r);
    for (int l = 1; l <= 16; l++) {
        if (h->maxcode[l] >= 0 && code <= h->maxcode[l])
            return h->vals[h->valptr[l] + (code - h->mincode[l])];
        code = (code << 1) | br_bit(r);
    }
    return -1;
}

static int extend(int v, int t) { /* spec F.2.2.1 EXTEND */
    if (!t) return 0;
    return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

/* separable float IDCT, 8x8 */
static void idct8x8(const int32_t in[64], double out[64]) {
    static double C[8][8];
    static int init = 0;
    if (!init) {
        for (int u = 0; u < 8; u++)
            for (int x = 0; x < 8; x++)
                C[u][x] = (u ? 1.0 : 0.70710678118654752) * 0.5
                          * cos((2 * x + 1) * u * M_PI / 16.0);
        init = 1;
    }
    double tmp[64];
    for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
            double s = 0;
            for (int u = 0; u < 8; u++)
                s += C[u][x] * in[y * 8 + u];
            tmp[y * 8 + x] = s;
        }
    for (int x = 0; x < 8; x++)
        for (int y = 0; y < 8; y++) {
            double s = 0;
            for (int v = 0; v < 8; v++)
                s += C[v][y] * tmp[v * 8 + x];
            out[y * 8 + x] = s;
        }
}

static const int ZIGZAG[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

long jpeg12_decode_gray(const uint8_t *data, size_t len, uint16_t *out,
                        size_t out_cap, int *ow, int *oh, int *oprec) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1; /* SOI */
    uint16_t qt[4][64];
    int qt_ok[4] = {0};
    Huff hdc[4], hac[4];
    int hdc_ok[4] = {0}, hac_ok[4] = {0};
    int W = 0, H = 0, prec = 0, qidx = 0, restart = 0;

    size_t i = 2;
    while (i + 4 <= len) {
        if (data[i] != 0xFF) { i++; continue; }
        uint8_t m = data[i + 1];
        if (m == 0xFF) { i++; continue; }
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
            i += 2;
            continue;
        }
        if (m == 0xD9) break; /* EOI */
        if (i + 4 > len) return -2;
        int seglen = (data[i + 2] << 8) | data[i + 3];
        const uint8_t *p = data + i + 4;
        int plen = seglen - 2;
        if (i + 2 + seglen > len) return -2;

        if (seglen < 2) return -2;
        if (m == 0xDB) { /* DQT */
            while (plen > 0) {
                int pq = p[0] >> 4, tq = p[0] & 15;
                p++;
                plen--;
                if (tq > 3) return -3;
                if (plen < (pq ? 128 : 64)) return -11;
                for (int k = 0; k < 64; k++) {
                    if (pq) { qt[tq][k] = (p[0] << 8) | p[1]; p += 2; plen -= 2; }
                    else { qt[tq][k] = p[0]; p++; plen--; }
                }
                qt_ok[tq] = 1;
            }
        } else if (m == 0xC4) { /* DHT */
            while (plen > 0) {
                int tc = p[0] >> 4, th = p[0] & 15;
                if (th > 3 || tc > 1) return -3;
                if (plen < 17) return -11;
                const uint8_t *counts = p + 1;
                int nv = 0;
                for (int k = 0; k < 16; k++) nv += counts[k];
                if (nv > 256) return -3;
                if (plen < 17 + nv) return -11;
                if (tc == 0) {
                    if (huff_build(&hdc[th], counts, p + 17, nv)) return -14;
                    hdc_ok[th] = 1;
                } else {
                    if (huff_build(&hac[th], counts, p + 17, nv)) return -14;
                    hac_ok[th] = 1;
                }
                p += 17 + nv;
                plen -= 17 + nv;
            }
        } else if (m == 0xC0 || m == 0xC1) { /* SOF0/1 */
            if (plen < 6) return -11;
            if (p[5] == 1 && plen < 9) return -11;
            prec = p[0];
            H = (p[1] << 8) | p[2];
            W = (p[3] << 8) | p[4];
            if (p[5] != 1) return -4;          /* one component only */
            if ((p[7] >> 4) != 1 || (p[7] & 15) != 1) return -4;
            qidx = p[8];
            if (qidx > 3) return -12;
            if (prec != 8 && prec != 12) return -5;
        } else if (m == 0xC2 || (m >= 0xC5 && m <= 0xCF && m != 0xC8)) {
            return -6; /* progressive/arithmetic/hierarchical unsupported */
        } else if (m == 0xDD) { /* DRI */
            if (plen < 2) return -11;
            restart = (p[0] << 8) | p[1];
        } else if (m == 0xDA) { /* SOS */
            if (!W || !H || !qt_ok[qidx]) return -7;
            if (plen < 1) return -11;
            int ns = p[0];
            if (ns != 1) return -4;
            if (plen < 6) return -11;
            int td = p[2] >> 4, ta = p[2] & 15;
            if (td > 3 || ta > 3) return -12;
            if (!hdc_ok[td] || !hac_ok[ta]) return -7;
            if ((size_t)W * H > out_cap) return -8;
            size_t scan_start = i + 2 + seglen;
            BR r = {data, len, scan_start, 0, 0, 0};
            int bw = (W + 7) / 8, bh = (H + 7) / 8;
            int pred = 0, mcu = 0;
            int32_t blk[64];
            double px[64];
            int shift = 1 << (prec - 1);
            int maxv = (1 << prec) - 1;
            for (int by = 0; by < bh; by++)
                for (int bx = 0; bx < bw; bx++) {
                    if (restart && mcu && mcu % restart == 0) {
                        /* byte-align + RSTn marker */
                        r.nacc = 0;
                        r.marker_hit = 0;
                        while (r.i + 1 < r.n && !(r.d[r.i] == 0xFF
                               && r.d[r.i + 1] >= 0xD0
                               && r.d[r.i + 1] <= 0xD7))
                            r.i++;
                        if (r.i + 1 < r.n) r.i += 2;
                        pred = 0;
                    }
                    memset(blk, 0, sizeof(blk));
                    int t = huff_decode(&r, &hdc[td]);
                    if (t < 0) return -9;
                    if (t > 16) return -13;
                    pred += extend(br_bits(&r, t), t);
                    blk[0] = pred * qt[qidx][0];
                    for (int k = 1; k < 64;) {
                        int rs = huff_decode(&r, &hac[ta]);
                        if (rs < 0) return -9;
                        int rl = rs >> 4, sz = rs & 15;
                        if (!sz) {
                            if (rl != 15) break; /* EOB */
                            k += 16;
                            continue;
                        }
                        k += rl;
                        if (k > 63) break;
                        blk[ZIGZAG[k]] = extend(br_bits(&r, sz), sz)
                                         * qt[qidx][k];
                        k++;
                    }
                    idct8x8(blk, px);
                    for (int y = 0; y < 8; y++) {
                        int iy = by * 8 + y;
                        if (iy >= H) break;
                        for (int x = 0; x < 8; x++) {
                            int ix = bx * 8 + x;
                            if (ix >= W) continue;
                            long v = lrint(px[y * 8 + x]) + shift;
                            out[(size_t)iy * W + ix] =
                                (uint16_t)(v < 0 ? 0 : v > maxv ? maxv : v);
                        }
                    }
                    mcu++;
                }
            *ow = W;
            *oh = H;
            *oprec = prec;
            return 0;
        }
        i += 2 + seglen;
    }
    return -10; /* no SOS */
}
