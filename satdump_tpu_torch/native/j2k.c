/* JPEG 2000 Part 1 (ITU-T T.800) decoder for one-component codestreams.
 *
 * Written from the standard for the PyTorch port of satdump_tpu, whose
 * card machine has no OpenJPEG: GK-2A's LRIT/HRIT image segments and GOES-R
 * GRB's ABI and SUVI blocks are JPEG 2000. It takes a raw codestream or a
 * JP2 file (the `jp2c` box), one component of 1-16 bits (signed or not),
 * any tiling and tile-parts, 1-33 resolutions, quality layers, precincts,
 * any code-block size, all five progression orders, SOP and EPH markers,
 * the code-block styles RESET, VSC, ERTERM and SEGSYM, and the reversible
 * 5/3 and irreversible 9/7 transforms. It refuses, with a message, several
 * components, subsampled components, ROI (RGN), progression order changes
 * (POC), packed packet headers (PPM/PPT) and the BYPASS, TERMALL and HT
 * code-block styles.
 *
 * Parts: the marker parser (Annex A), tier-2 (Annex B: tag trees, packet
 * headers, progression iterators), tier-1 (Annexes C-D: the MQ decoder and
 * EBCOT's significance, refinement and cleanup passes), dequantization
 * (Annex E) and the inverse DWT (Annex F). The irreversible path follows
 * OpenJPEG's float arithmetic (the 9/7 lifting with its 2/K high-band
 * scale, steps in float, lrintf at the end), so its pixels come within one
 * level of OpenJPEG's; the reversible path is integer and exact.
 *
 * The input came over a radio link: every read is bounds-checked and a
 * corrupt stream returns a negative code with a message, never a crash.
 *
 * API:
 *   int j2k_header(const uint8_t *d, size_t n, int *w, int *h, int *prec,
 *                  int *sgnd, char *err, int errlen);
 *   int j2k_decode(const uint8_t *d, size_t n, int32_t *out, size_t cap,
 *                  double *times, char *err, int errlen);
 *   0 on success; out holds (h, w) samples after the DC level shift;
 *   times[0..2] += seconds in tier-2, tier-1 and the inverse DWT.
 */

#include <math.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

/* 2^26 pixels (a 256 MB int32 plane): well above an xRIT segment's or a
   GRB block's size */
#define J2K_MAX_PIXELS ((int64_t)1 << 26)
#define MAXRES 33
#define MAXBANDS (1 + 3 * (MAXRES - 1))

/* ------------------------------------------------------------- errors -- */
typedef struct {
    char *msg;
    int len;
} Err;

static int fail(Err *e, int code, const char *fmt, ...) {
    if (e->msg && e->len > 0) {
        va_list ap;
        va_start(ap, fmt);
        vsnprintf(e->msg, (size_t)e->len, fmt, ap);
        va_end(ap);
    }
    return code;
}

static double now(void) {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

static int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
static int64_t ceilpow2(int64_t a, int e) {
    return (a + ((int64_t)1 << e) - 1) >> e;
}
static int64_t floorpow2(int64_t a, int e) { return a >> e; }
static int floorlog2(unsigned v) {
    int l = 0;
    while (v > 1) { v >>= 1; l++; }
    return l;
}

/* ---------------------------------------------------------- coding style */
typedef struct {
    int nl;              /* decomposition levels */
    int xcb, ycb;        /* code-block size exponents */
    int style;           /* code-block style flags */
    int rev;             /* 1: 5/3, 0: 9/7 */
    int ppx[MAXRES], ppy[MAXRES];
    int sop, eph, prog, layers;
    int qstyle, guard;
    int eps[MAXBANDS], mu[MAXBANDS];
    int nq;              /* entries given in QCD/QCC */
} Style;

typedef struct {
    int64_t x1, y1, x0, y0, tw, th, tx0, ty0;
    int prec, sgnd;
    int ntx, nty;
    Style def;
    int have_cod, have_qcd;
} Image;

/* ----------------------------------------------------------- byte reader */
typedef struct {
    const uint8_t *d;
    size_t n, i;
} Rd;

static int rd8(Rd *r, unsigned *v) {
    if (r->i + 1 > r->n) return -1;
    *v = r->d[r->i++];
    return 0;
}
static int rd16(Rd *r, unsigned *v) {
    if (r->i + 2 > r->n) return -1;
    *v = (unsigned)r->d[r->i] << 8 | r->d[r->i + 1];
    r->i += 2;
    return 0;
}
static int rd32(Rd *r, uint32_t *v) {
    if (r->i + 4 > r->n) return -1;
    *v = (uint32_t)r->d[r->i] << 24 | (uint32_t)r->d[r->i + 1] << 16
         | (uint32_t)r->d[r->i + 2] << 8 | r->d[r->i + 3];
    r->i += 4;
    return 0;
}

/* ------------------------------------------------------- JP2 container --- */
/* The codestream inside a JP2 file's jp2c box, or the buffer itself. */
static int find_codestream(const uint8_t *d, size_t n, size_t *off,
                           size_t *len, Err *e) {
    static const uint8_t sig[12] = {0, 0, 0, 12, 'j', 'P', ' ', ' ',
                                    0x0D, 0x0A, 0x87, 0x0A};
    if (n >= 2 && d[0] == 0xFF && d[1] == 0x4F) {
        *off = 0;
        *len = n;
        return 0;
    }
    if (n < 12 || memcmp(d, sig, 12)) return fail(e, -1, "not a JPEG 2000 "
                                                  "codestream or JP2 file");
    size_t i = 12;
    while (i + 8 <= n) {
        uint64_t lbox = (uint64_t)d[i] << 24 | (uint64_t)d[i + 1] << 16
                        | (uint64_t)d[i + 2] << 8 | d[i + 3];
        size_t hdr = 8;
        if (lbox == 1) {
            if (i + 16 > n) break;
            lbox = 0;
            for (int k = 0; k < 8; k++) lbox = lbox << 8 | d[i + 8 + k];
            hdr = 16;
        } else if (lbox == 0) {
            lbox = n - i;
        }
        if (lbox < hdr || lbox > n - i) return fail(e, -1, "JP2 box overruns "
                                                    "the file");
        if (!memcmp(d + i + 4, "jp2c", 4)) {
            *off = i + hdr;
            *len = (size_t)lbox - hdr;
            return 0;
        }
        i += (size_t)lbox;
    }
    return fail(e, -1, "JP2 file without a jp2c box");
}

/* ----------------------------------------------------- marker segments --- */
static int parse_cod_sp(Rd *r, Style *s, int scod, Err *e) {
    unsigned v, nl, xcb, ycb, st, tr;
    if (rd8(r, &nl) || rd8(r, &xcb) || rd8(r, &ycb) || rd8(r, &st)
        || rd8(r, &tr))
        return fail(e, -2, "truncated COD/COC segment");
    if (nl > MAXRES - 1) return fail(e, -2, "%u decomposition levels", nl);
    if (xcb > 8 || ycb > 8 || xcb + ycb > 8)
        return fail(e, -2, "bad code-block size");
    if (st & (0x01 | 0x04 | 0x40 | 0x80))
        return fail(e, -3, "code-block style 0x%02x (BYPASS, TERMALL or HT) "
                    "not taken", st);
    if (tr > 1) return fail(e, -2, "unknown wavelet transform %u", tr);
    s->nl = (int)nl;
    s->xcb = (int)xcb + 2;
    s->ycb = (int)ycb + 2;
    s->style = (int)st;
    s->rev = (int)tr;
    for (int k = 0; k <= (int)nl; k++) {
        if (scod & 1) {
            if (rd8(r, &v)) return fail(e, -2, "truncated precinct sizes");
            s->ppx[k] = (int)(v & 15);
            s->ppy[k] = (int)(v >> 4);
            if (k && (!s->ppx[k] || !s->ppy[k]))
                return fail(e, -2, "precinct exponent 0 above resolution 0");
        } else {
            s->ppx[k] = s->ppy[k] = 15;
        }
    }
    return 0;
}

static int parse_cod(Rd *r, Style *s, Err *e) {
    unsigned scod, prog, layers, mct;
    if (rd8(r, &scod) || rd8(r, &prog) || rd16(r, &layers) || rd8(r, &mct))
        return fail(e, -2, "truncated COD segment");
    if (prog > 4) return fail(e, -2, "unknown progression order %u", prog);
    if (!layers) return fail(e, -2, "zero quality layers");
    s->sop = (scod >> 1) & 1;
    s->eph = (scod >> 2) & 1;
    s->prog = (int)prog;
    s->layers = (int)layers;
    return parse_cod_sp(r, s, (int)scod, e);
}

static int parse_qcd(Rd *r, size_t end, Style *s, Err *e) {
    unsigned sq, v;
    if (rd8(r, &sq)) return fail(e, -2, "truncated QCD segment");
    s->qstyle = (int)(sq & 31);
    s->guard = (int)(sq >> 5);
    if (s->qstyle > 2) return fail(e, -2, "quantization style %d", s->qstyle);
    int k = 0;
    while (r->i < end && k < MAXBANDS) {
        if (s->qstyle == 0) {
            if (rd8(r, &v)) return fail(e, -2, "truncated QCD segment");
            s->eps[k] = (int)(v >> 3);
            s->mu[k] = 0;
        } else {
            if (rd16(r, &v)) return fail(e, -2, "truncated QCD segment");
            s->eps[k] = (int)(v >> 11);
            s->mu[k] = (int)(v & 0x7FF);
        }
        k++;
        if (s->qstyle == 1) break;
    }
    if (!k) return fail(e, -2, "QCD without step sizes");
    s->nq = k;
    return 0;
}

/* exponent and mantissa of band (r, b): b 0 for LL, else 0 HL 1 LH 2 HH */
static void band_quant(const Style *s, int r, int b, int *eps, int *mu) {
    int idx = r ? 3 * (r - 1) + 1 + b : 0;
    if (s->qstyle == 1) {
        int nb = r ? s->nl - r + 1 : s->nl;
        *eps = s->eps[0] - s->nl + nb;
        *mu = s->mu[0];
    } else {
        if (idx >= s->nq) idx = s->nq - 1;
        *eps = s->eps[idx];
        *mu = s->mu[idx];
    }
}

/* ====================================================== tier-1: MQ + EBCOT */
static const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
static const uint8_t NMPS[47] = {
    1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
static const uint8_t NLPS[47] = {
    1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
    15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
static const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0,
                                   0, 0, 1};

enum { CTX_RL = 17, CTX_UNI = 18, NCTX = 19 };

typedef struct {
    const uint8_t *bp, *end; /* end: two 0xFF sentinel bytes follow */
    uint32_t a, c;
    int ct;
    uint8_t idx[NCTX], mps[NCTX];
} MQ;

static void mq_reset_ctx(MQ *m) {
    memset(m->idx, 0, sizeof m->idx);
    memset(m->mps, 0, sizeof m->mps);
    m->idx[CTX_UNI] = 46;
    m->idx[CTX_RL] = 3;
    m->idx[0] = 4;
}

static void mq_bytein(MQ *m) {
    if (*m->bp == 0xFF) {
        if (m->bp[1] > 0x8F) {
            m->c += 0xFF00;
            m->ct = 8;
        } else {
            m->bp++;
            m->c += (uint32_t)*m->bp << 9;
            m->ct = 7;
        }
    } else {
        m->bp++;
        m->c += (uint32_t)*m->bp << 8;
        m->ct = 8;
    }
}

static void mq_init(MQ *m, const uint8_t *bp, const uint8_t *end) {
    m->bp = bp;
    m->end = end;
    m->c = (uint32_t)*bp << 16;
    mq_bytein(m);
    m->c <<= 7;
    m->ct -= 7;
    m->a = 0x8000;
}

static int mq_decode(MQ *m, int cx) {
    int i = m->idx[cx], d;
    uint32_t qe = QE[i];
    m->a -= qe;
    if ((m->c >> 16) < qe) {             /* LPS sub-interval (exchange) */
        if (m->a < qe) {
            d = m->mps[cx];
            m->idx[cx] = NMPS[i];
        } else {
            d = 1 - m->mps[cx];
            if (SWITCH[i]) m->mps[cx] = (uint8_t)(1 - m->mps[cx]);
            m->idx[cx] = NLPS[i];
        }
        m->a = qe;
    } else {
        m->c -= qe << 16;
        if (m->a & 0x8000) return m->mps[cx];
        if (m->a < qe) {
            d = 1 - m->mps[cx];
            if (SWITCH[i]) m->mps[cx] = (uint8_t)(1 - m->mps[cx]);
            m->idx[cx] = NLPS[i];
        } else {
            d = m->mps[cx];
            m->idx[cx] = NMPS[i];
        }
    }
    do { /* RENORMD */
        if (!m->ct) {
            if (m->bp >= m->end) { /* past the data: feed 1s, as 0xFF */
                m->c += 0xFF00;
                m->ct = 8;
            } else {
                mq_bytein(m);
            }
        }
        m->a <<= 1;
        m->c <<= 1;
        m->ct--;
    } while (!(m->a & 0x8000));
    return d;
}

/* flags of a sample (the code-block padded by one on each side) */
enum { F_SIG = 1, F_NEG = 2, F_VIS = 4, F_REF = 8 };

typedef struct {
    int w, h, orient, vsc;
    uint8_t *f;          /* (h + 2) x (w + 2) */
    int32_t *v;          /* h x w magnitudes (x2 representation) */
    MQ mq;
} T1;

#define FL(t, x, y) ((t)->f[((y) + 1) * ((t)->w + 2) + (x) + 1])

/* significance of the neighbour (x+dx, y+dy) as context for (x, y) */
static inline int nsig(const T1 *t, int x, int y, int dx, int dy) {
    if (dy > 0 && t->vsc && ((y & 3) == 3)) return 0;
    return FL(t, x + dx, y + dy) & F_SIG;
}

static int zc_ctx(const T1 *t, int x, int y) {
    int h = nsig(t, x, y, -1, 0) + nsig(t, x, y, 1, 0);
    int v = nsig(t, x, y, 0, -1) + nsig(t, x, y, 0, 1);
    int d = nsig(t, x, y, -1, -1) + nsig(t, x, y, 1, -1)
            + nsig(t, x, y, -1, 1) + nsig(t, x, y, 1, 1);
    if (t->orient == 3) { /* HH */
        int hv = h + v;
        if (d >= 3) return 8;
        if (d == 2) return hv >= 1 ? 7 : 6;
        if (d == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
        return hv >= 2 ? 2 : hv;
    }
    if (t->orient == 1) { int s = h; h = v; v = s; } /* HL */
    if (h == 2) return 8;
    if (h == 1) return v ? 7 : d ? 6 : 5;
    if (v) return v == 2 ? 4 : 3;
    return d >= 2 ? 2 : d;
}

static inline int ncontrib(const T1 *t, int x, int y, int dx, int dy) {
    if (dy > 0 && t->vsc && ((y & 3) == 3)) return 0;
    uint8_t f = FL(t, x + dx, y + dy);
    if (!(f & F_SIG)) return 0;
    return (f & F_NEG) ? -1 : 1;
}

/* the sign's context of (x, y), and in *xr the bit it is XORed with */
static int sign_ctx(const T1 *t, int x, int y, int *xr) {
    int h = ncontrib(t, x, y, -1, 0) + ncontrib(t, x, y, 1, 0);
    int v = ncontrib(t, x, y, 0, -1) + ncontrib(t, x, y, 0, 1);
    h = h > 0 ? 1 : h < 0 ? -1 : 0;
    v = v > 0 ? 1 : v < 0 ? -1 : 0;
    int ctx;
    *xr = 0;
    if (h == 1) ctx = v == 1 ? 13 : v == 0 ? 12 : 11;
    else if (h == 0) { ctx = v ? 10 : 9; *xr = v == -1; }
    else { ctx = v == 1 ? 11 : v == 0 ? 12 : 13; *xr = 1; }
    return ctx;
}

static int decode_sign(T1 *t, int x, int y) {
    int xr, ctx = sign_ctx(t, x, y, &xr);
    return mq_decode(&t->mq, ctx) ^ xr;
}

static inline int any_sig(const T1 *t, int x, int y) {
    for (int dy = -1; dy <= 1; dy++)
        for (int dx = -1; dx <= 1; dx++)
            if ((dx || dy) && nsig(t, x, y, dx, dy)) return 1;
    return 0;
}

static void make_sig(T1 *t, int x, int y, int p) {
    int neg = decode_sign(t, x, y);
    FL(t, x, y) |= (uint8_t)(F_SIG | (neg ? F_NEG : 0));
    t->v[y * t->w + x] = 3 << p; /* the bit and half the rest, doubled */
}

static void pass_sig(T1 *t, int p) {
    for (int y0 = 0; y0 < t->h; y0 += 4)
        for (int x = 0; x < t->w; x++)
            for (int y = y0; y < y0 + 4 && y < t->h; y++) {
                uint8_t *f = &FL(t, x, y);
                if ((*f & F_SIG) || !any_sig(t, x, y)) continue;
                *f |= F_VIS;
                if (mq_decode(&t->mq, zc_ctx(t, x, y))) make_sig(t, x, y, p);
            }
}

static void pass_ref(T1 *t, int p) {
    for (int y0 = 0; y0 < t->h; y0 += 4)
        for (int x = 0; x < t->w; x++)
            for (int y = y0; y < y0 + 4 && y < t->h; y++) {
                uint8_t *f = &FL(t, x, y);
                if ((*f & (F_SIG | F_VIS)) != F_SIG) continue;
                int ctx = (*f & F_REF) ? 16 : any_sig(t, x, y) ? 15 : 14;
                int b = mq_decode(&t->mq, ctx);
                int32_t *v = &t->v[y * t->w + x];
                *v += b ? (1 << p) : -(1 << p);
                *f |= F_REF;
            }
}

static void pass_clean(T1 *t, int p, int segsym) {
    for (int y0 = 0; y0 < t->h; y0 += 4)
        for (int x = 0; x < t->w; x++) {
            int y = y0;
            if (y0 + 4 <= t->h) {
                int rl = 1;
                for (int k = 0; k < 4 && rl; k++)
                    if ((FL(t, x, y0 + k) & (F_SIG | F_VIS))
                        || any_sig(t, x, y0 + k))
                        rl = 0;
                if (rl) {
                    if (!mq_decode(&t->mq, CTX_RL)) continue;
                    int r = mq_decode(&t->mq, CTX_UNI) << 1;
                    r |= mq_decode(&t->mq, CTX_UNI);
                    y = y0 + r;
                    make_sig(t, x, y, p);
                    y++;
                }
            }
            for (; y < y0 + 4 && y < t->h; y++) {
                uint8_t *f = &FL(t, x, y);
                if (*f & (F_SIG | F_VIS)) continue;
                if (mq_decode(&t->mq, zc_ctx(t, x, y))) make_sig(t, x, y, p);
            }
        }
    for (int y = 0; y < t->h; y++)
        for (int x = 0; x < t->w; x++) FL(t, x, y) &= (uint8_t)~F_VIS;
    if (segsym)
        for (int k = 0; k < 4; k++) mq_decode(&t->mq, CTX_UNI);
}

/* ============================================================ structures */
typedef struct {
    int64_t x0, y0, x1, y1;    /* in band coordinates */
    int included, zbp, lblock, passes;
    uint8_t *data;
    size_t len, cap;
} Cblk;

typedef struct { /* a tag tree */
    int w, h, nlev, n;
    int lw[40], lh[40], off[40];
    int *val, *low;
    uint8_t *known;    /* the encoder's: the node's value was sent */
} Tag;

typedef struct {
    int cw, ch;
    Cblk *cb;
    Tag incl, zbp;
} PrecBand;

typedef struct {
    int64_t x0, y0, x1, y1;    /* band bounds */
    int orient;                /* 0 LL, 1 HL, 2 LH, 3 HH */
    int mb;                    /* Mb = guard + eps - 1 */
    float step;                /* irreversible: 0.5 * Delta_b */
    int cbw, cbh;              /* code-block exponents in this resolution */
} Band;

typedef struct {
    int64_t x0, y0, x1, y1;    /* resolution bounds */
    int nb;                    /* bands: 1 at r = 0, else 3 */
    Band band[3];
    int ppx, ppy, pw, ph;
    PrecBand *prec;            /* pw * ph * nb */
} Res;

static int tag_init(Tag *t, int w, int h) {
    memset(t, 0, sizeof *t);
    t->w = w;
    t->h = h;
    int n = 0, lev = 0;
    int cw = w, ch = h;
    for (;;) {
        if (lev >= 40) return -1;
        t->lw[lev] = cw;
        t->lh[lev] = ch;
        t->off[lev] = n;
        n += cw * ch;
        lev++;
        if (cw <= 1 && ch <= 1) break;
        cw = (cw + 1) / 2;
        ch = (ch + 1) / 2;
    }
    t->nlev = lev;
    t->n = n;
    t->val = malloc(sizeof(int) * (size_t)(n ? n : 1));
    t->low = calloc((size_t)(n ? n : 1), sizeof(int));
    if (!t->val || !t->low) return -1;
    for (int i = 0; i < n; i++) t->val[i] = 1 << 30;
    return 0;
}

static void tag_free(Tag *t) {
    free(t->val);
    free(t->low);
    free(t->known);
}

/* ------------------------------------------------- packet header bit I/O */
typedef struct {
    const uint8_t *p, *end;
    unsigned buf;
    int ct;
    int over; /* read past the end */
} Bio;

static int bio_bit(Bio *b) {
    if (!b->ct) {
        b->buf = (b->buf << 8) & 0xFFFF;
        b->ct = b->buf == 0xFF00 ? 7 : 8;
        if (b->p >= b->end) b->over = 1;
        else b->buf |= *b->p++;
    }
    b->ct--;
    return (int)((b->buf >> b->ct) & 1);
}

static unsigned bio_bits(Bio *b, int n) {
    unsigned v = 0;
    while (n--) v = v << 1 | (unsigned)bio_bit(b);
    return v;
}

static void bio_align(Bio *b) {
    if ((b->buf & 0xFF) == 0xFF) {
        b->buf = (b->buf << 8) & 0xFFFF;
        if (b->p >= b->end) b->over = 1;
        else b->buf |= *b->p++;
    }
    b->ct = 0;
}

/* is the leaf's value below threshold? (B.10.2) */
static int tag_decode(Tag *t, Bio *b, int leaf, int thr) {
    int path[40];
    int x = leaf % t->w, y = leaf / t->w;
    for (int l = 0; l < t->nlev; l++) {
        path[l] = t->off[l] + y * t->lw[l] + x;
        x >>= 1;
        y >>= 1;
    }
    int low = 0;
    for (int l = t->nlev - 1; l >= 0; l--) {
        int k = path[l];
        if (low > t->low[k]) t->low[k] = low;
        else low = t->low[k];
        while (low < thr && low < t->val[k]) {
            if (b->over) return -1;
            if (bio_bit(b)) t->val[k] = low;
            else low++;
        }
        t->low[k] = low;
    }
    return t->val[path[0]] < thr;
}

/* ================================================================ a tile */
typedef struct {
    int64_t x0, y0, x1, y1;
    Style st;
    Res res[MAXRES];
    int nres;
    uint8_t *data;     /* the tile's bit stream (its tile-parts' bodies) */
    size_t len, cap;
    int seen;          /* a tile-part of this tile was read */
} Tile;

static void tile_free(Tile *t) {
    for (int r = 0; r < t->nres; r++) {
        Res *R = &t->res[r];
        if (!R->prec) continue;
        for (int k = 0; k < R->pw * R->ph * R->nb; k++) {
            PrecBand *pb = &R->prec[k];
            if (pb->cb)
                for (int c = 0; c < pb->cw * pb->ch; c++) free(pb->cb[c].data);
            free(pb->cb);
            tag_free(&pb->incl);
            tag_free(&pb->zbp);
        }
        free(R->prec);
        R->prec = NULL;
    }
    free(t->data);
    t->data = NULL;
}

static int append(uint8_t **buf, size_t *len, size_t *cap, const uint8_t *src,
                  size_t n) {
    if (*len + n + 2 > *cap) {
        size_t c = (*cap ? *cap : 64);
        while (*len + n + 2 > c) c *= 2;
        uint8_t *nb = realloc(*buf, c);
        if (!nb) return -1;
        *buf = nb;
        *cap = c;
    }
    memcpy(*buf + *len, src, n);
    *len += n;
    return 0;
}

static int tile_setup(Tile *t, const Image *im, Err *e) {
    const Style *s = &t->st;
    t->nres = s->nl + 1;
    int prec = im->prec;
    for (int r = 0; r < t->nres; r++) {
        Res *R = &t->res[r];
        int lev = s->nl - r;
        R->x0 = ceilpow2(t->x0, lev);
        R->y0 = ceilpow2(t->y0, lev);
        R->x1 = ceilpow2(t->x1, lev);
        R->y1 = ceilpow2(t->y1, lev);
        R->ppx = s->ppx[r];
        R->ppy = s->ppy[r];
        R->pw = R->x0 == R->x1 ? 0
                : (int)(ceilpow2(R->x1, R->ppx) - floorpow2(R->x0, R->ppx));
        R->ph = R->y0 == R->y1 ? 0
                : (int)(ceilpow2(R->y1, R->ppy) - floorpow2(R->y0, R->ppy));
        if ((int64_t)R->pw * R->ph > (1 << 24))
            return fail(e, -2, "too many precincts");
        R->nb = r ? 3 : 1;
        int cbgw = r ? R->ppx - 1 : R->ppx, cbgh = r ? R->ppy - 1 : R->ppy;
        for (int b = 0; b < R->nb; b++) {
            Band *B = &R->band[b];
            int orient = r ? b + 1 : 0;
            int nb = r ? s->nl - r + 1 : s->nl;
            int xob = orient & 1, yob = orient >> 1;
            B->orient = orient;
            B->x0 = r ? ceilpow2(t->x0 - ((int64_t)xob << (nb - 1)), nb)
                      : ceilpow2(t->x0, nb);
            B->y0 = r ? ceilpow2(t->y0 - ((int64_t)yob << (nb - 1)), nb)
                      : ceilpow2(t->y0, nb);
            B->x1 = r ? ceilpow2(t->x1 - ((int64_t)xob << (nb - 1)), nb)
                      : ceilpow2(t->x1, nb);
            B->y1 = r ? ceilpow2(t->y1 - ((int64_t)yob << (nb - 1)), nb)
                      : ceilpow2(t->y1, nb);
            int eps, mu;
            band_quant(s, r, b, &eps, &mu);
            B->mb = s->guard + eps - 1;
            if (B->mb > 30) return fail(e, -2, "%d magnitude bit planes",
                                        B->mb);
            /* OpenJPEG's decoder: R_b = precision (no band gain; its 9/7
             * scales the high band by 2/K instead) */
            B->step = (float)((1.0 + mu / 2048.0) * pow(2.0, prec - eps))
                      * 0.5f;
            B->cbw = s->xcb < cbgw ? s->xcb : cbgw;
            B->cbh = s->ycb < cbgh ? s->ycb : cbgh;
        }
        if (!R->pw || !R->ph) continue;
        R->prec = calloc((size_t)R->pw * R->ph * R->nb, sizeof(PrecBand));
        if (!R->prec) return fail(e, -4, "out of memory");
        int64_t px0 = floorpow2(R->x0, R->ppx) << R->ppx;
        int64_t py0 = floorpow2(R->y0, R->ppy) << R->ppy;
        int64_t gx0 = r ? ceilpow2(px0, 1) : px0, gy0 = r ? ceilpow2(py0, 1)
                                                          : py0;
        for (int pj = 0; pj < R->ph; pj++)
            for (int pi = 0; pi < R->pw; pi++)
                for (int b = 0; b < R->nb; b++) {
                    Band *B = &R->band[b];
                    PrecBand *pb = &R->prec[(pj * R->pw + pi) * R->nb + b];
                    int64_t cx0 = gx0 + ((int64_t)pi << cbgw);
                    int64_t cy0 = gy0 + ((int64_t)pj << cbgh);
                    int64_t x0 = cx0 > B->x0 ? cx0 : B->x0;
                    int64_t y0 = cy0 > B->y0 ? cy0 : B->y0;
                    int64_t x1 = cx0 + ((int64_t)1 << cbgw);
                    int64_t y1 = cy0 + ((int64_t)1 << cbgh);
                    if (x1 > B->x1) x1 = B->x1;
                    if (y1 > B->y1) y1 = B->y1;
                    if (x0 >= x1 || y0 >= y1) {
                        pb->cw = pb->ch = 0;
                    } else {
                        int64_t bx0 = floorpow2(x0, B->cbw) << B->cbw;
                        int64_t by0 = floorpow2(y0, B->cbh) << B->cbh;
                        pb->cw = (int)((ceilpow2(x1, B->cbw) << B->cbw) - bx0)
                                 >> B->cbw;
                        pb->ch = (int)((ceilpow2(y1, B->cbh) << B->cbh) - by0)
                                 >> B->cbh;
                        if ((int64_t)pb->cw * pb->ch > (1 << 22))
                            return fail(e, -2, "too many code-blocks");
                        pb->cb = calloc((size_t)pb->cw * pb->ch, sizeof(Cblk));
                        if (!pb->cb) return fail(e, -4, "out of memory");
                        for (int j = 0; j < pb->ch; j++)
                            for (int i = 0; i < pb->cw; i++) {
                                Cblk *c = &pb->cb[j * pb->cw + i];
                                int64_t a0 = bx0 + ((int64_t)i << B->cbw);
                                int64_t b0 = by0 + ((int64_t)j << B->cbh);
                                c->x0 = a0 > x0 ? a0 : x0;
                                c->y0 = b0 > y0 ? b0 : y0;
                                c->x1 = a0 + (1 << B->cbw);
                                c->y1 = b0 + (1 << B->cbh);
                                if (c->x1 > x1) c->x1 = x1;
                                if (c->y1 > y1) c->y1 = y1;
                                c->lblock = 3;
                            }
                    }
                    if (tag_init(&pb->incl, pb->cw ? pb->cw : 1,
                                 pb->ch ? pb->ch : 1)
                        || tag_init(&pb->zbp, pb->cw ? pb->cw : 1,
                                    pb->ch ? pb->ch : 1))
                        return fail(e, -4, "out of memory");
                }
    }
    return 0;
}

/* ----------------------------------------------------------- one packet */
static int read_packet(Tile *t, const uint8_t **pp, const uint8_t *end,
                       int layer, int r, int prec, Err *e) {
    Res *R = &t->res[r];
    const uint8_t *p = *pp;
    if (t->st.sop && end - p >= 6 && p[0] == 0xFF && p[1] == 0x91) p += 6;
    Bio b = {p, end, 0, 0, 0};
    int present = p < end ? bio_bit(&b) : 0;
    /* lengths of the code-blocks' contributions, in header order */
    size_t nlen = 0, cap = 0;
    Cblk **who = NULL;
    size_t *lens = NULL;
    int rc = 0;
    if (present) {
        for (int bb = 0; bb < R->nb; bb++) {
            PrecBand *pb = &R->prec[prec * R->nb + bb];
            Band *B = &R->band[bb];
            for (int k = 0; k < pb->cw * pb->ch; k++) {
                Cblk *c = &pb->cb[k];
                int inc;
                if (!c->included) {
                    inc = tag_decode(&pb->incl, &b, k, layer + 1);
                } else {
                    inc = bio_bit(&b);
                }
                if (inc < 0 || b.over) { rc = -5; goto done; }
                if (!inc) continue;
                if (!c->included) {
                    int z = 0;
                    for (;;) {
                        int d = tag_decode(&pb->zbp, &b, k, z + 1);
                        if (d < 0) { rc = -5; goto done; }
                        if (d) break;
                        if (++z > B->mb + 1) { rc = -6; goto done; }
                    }
                    c->zbp = z;
                    c->included = 1;
                }
                int np;
                if (!bio_bit(&b)) np = 1;
                else if (!bio_bit(&b)) np = 2;
                else {
                    unsigned v = bio_bits(&b, 2);
                    if (v != 3) np = 3 + (int)v;
                    else {
                        v = bio_bits(&b, 5);
                        np = v != 31 ? 6 + (int)v : 37 + (int)bio_bits(&b, 7);
                    }
                }
                while (bio_bit(&b)) {
                    if (++c->lblock > 32 || b.over) { rc = -6; goto done; }
                }
                int nbits = c->lblock + floorlog2((unsigned)np);
                if (nbits > 32) { rc = -6; goto done; }
                size_t len = 0;
                for (int i = 0; i < nbits; i++)
                    len = len << 1 | (size_t)bio_bit(&b);
                if (b.over) { rc = -5; goto done; }
                c->passes += np;
                if (nlen == cap) {
                    cap = cap ? 2 * cap : 16;
                    Cblk **w2 = realloc(who, cap * sizeof *who);
                    size_t *l2 = realloc(lens, cap * sizeof *lens);
                    if (w2) who = w2;
                    if (l2) lens = l2;
                    if (!w2 || !l2) { rc = -4; goto done; }
                }
                who[nlen] = c;
                lens[nlen++] = len;
            }
        }
    }
    bio_align(&b);
    if (b.over) { rc = -5; goto done; }
    p = b.p;
    if (t->st.eph && end - p >= 2 && p[0] == 0xFF && p[1] == 0x92) p += 2;
    for (size_t k = 0; k < nlen; k++) {
        if (lens[k] > (size_t)(end - p)) { rc = -5; goto done; }
        if (append(&who[k]->data, &who[k]->len, &who[k]->cap, p, lens[k])) {
            rc = -4;
            goto done;
        }
        p += lens[k];
    }
    *pp = p;
done:
    free(who);
    free(lens);
    if (rc == -5) return fail(e, -5, "packet (layer %d, resolution %d, "
                              "precinct %d) overruns the tile's data", layer,
                              r, prec);
    if (rc == -6) return fail(e, -6, "corrupt packet header (layer %d, "
                              "resolution %d)", layer, r);
    if (rc == -4) return fail(e, -4, "out of memory");
    return 0;
}

/* ------------------------------------------------- progression iterators */
typedef struct {
    Tile *t;
    const uint8_t *p, *end;
    uint8_t *done;        /* (layer, r, precinct) packets read */
    int64_t doff[MAXRES];
    Err *e;
} Walk;

static int emit(Walk *w, int l, int r, int k) {
    uint8_t *d = &w->done[w->doff[r] + (int64_t)l * w->t->res[r].pw
                          * w->t->res[r].ph + k];
    if (*d) return 0;
    *d = 1;
    if (w->p >= w->end) return 0; /* the stream ends: later packets empty */
    return read_packet(w->t, &w->p, w->end, l, r, k, w->e);
}

/* the precinct of resolution r at reference-grid point (x, y), or -1 */
static int prec_at(Tile *t, int r, int64_t x, int64_t y) {
    Res *R = &t->res[r];
    int lev = t->st.nl - r;
    if (!R->pw || !R->ph) return -1;
    int rpx = R->ppx + lev, rpy = R->ppy + lev;
    if (rpx > 62 || rpy > 62) return -1;
    int64_t mx = (int64_t)1 << rpx, my = (int64_t)1 << rpy;
    if (!(y % my == 0 || (y == t->y0 && ((R->y0 << lev) % my)))) return -1;
    if (!(x % mx == 0 || (x == t->x0 && ((R->x0 << lev) % mx)))) return -1;
    int64_t pi = floorpow2(ceilpow2(x, lev), R->ppx) - floorpow2(R->x0,
                                                                 R->ppx);
    int64_t pj = floorpow2(ceilpow2(y, lev), R->ppy) - floorpow2(R->y0,
                                                                 R->ppy);
    if (pi < 0 || pj < 0 || pi >= R->pw || pj >= R->ph) return -1;
    return (int)(pj * R->pw + pi);
}

static int walk_tile(Tile *t, Err *e) {
    Walk w = {t, t->data, t->data + t->len, NULL, {0}, e};
    int L = t->st.layers, nr = t->nres;
    int64_t tot = 0;
    for (int r = 0; r < nr; r++) {
        w.doff[r] = tot;
        tot += (int64_t)L * t->res[r].pw * t->res[r].ph;
    }
    w.done = calloc((size_t)(tot ? tot : 1), 1);
    if (!w.done) return fail(e, -4, "out of memory");
    int rc = 0;
    int prog = t->st.prog;
    if (prog == 0 || prog == 1) { /* LRCP, RLCP */
        for (int a = 0; a < (prog ? nr : L) && !rc; a++)
            for (int b2 = 0; b2 < (prog ? L : nr) && !rc; b2++) {
                int l = prog ? b2 : a, r = prog ? a : b2;
                for (int k = 0; k < t->res[r].pw * t->res[r].ph && !rc; k++)
                    rc = emit(&w, l, r, k);
            }
    } else {
        int64_t dx = INT64_MAX, dy = INT64_MAX;
        for (int r = 0; r < nr; r++) {
            int lev = t->st.nl - r;
            int ex = t->res[r].ppx + lev, ey = t->res[r].ppy + lev;
            if (ex < 62 && ((int64_t)1 << ex) < dx) dx = (int64_t)1 << ex;
            if (ey < 62 && ((int64_t)1 << ey) < dy) dy = (int64_t)1 << ey;
        }
        if (dx == INT64_MAX || dy == INT64_MAX) {
            free(w.done);
            return fail(e, -2, "precinct partition too large");
        }
        if (prog == 2) { /* RPCL */
            for (int r = 0; r < nr && !rc; r++)
                for (int64_t y = t->y0; y < t->y1 && !rc; y += dy - (y % dy))
                    for (int64_t x = t->x0; x < t->x1 && !rc;
                         x += dx - (x % dx)) {
                        int k = prec_at(t, r, x, y);
                        for (int l = 0; k >= 0 && l < L && !rc; l++)
                            rc = emit(&w, l, r, k);
                    }
        } else { /* PCRL, CPRL: with one component, the same order */
            for (int64_t y = t->y0; y < t->y1 && !rc; y += dy - (y % dy))
                for (int64_t x = t->x0; x < t->x1 && !rc; x += dx - (x % dx))
                    for (int r = 0; r < nr && !rc; r++) {
                        int k = prec_at(t, r, x, y);
                        for (int l = 0; k >= 0 && l < L && !rc; l++)
                            rc = emit(&w, l, r, k);
                    }
        }
    }
    free(w.done);
    return rc;
}

/* ------------------------------------------------------- tier-1 blocks */
static int decode_cblk(Cblk *c, const Band *B, int style, T1 *t1, int32_t *v,
                       Err *e) {
    int w = (int)(c->x1 - c->x0), h = (int)(c->y1 - c->y0);
    memset(v, 0, sizeof(int32_t) * (size_t)w * h);
    if (!c->passes || !c->len) return 0;
    int nbp = B->mb - c->zbp;
    if (nbp <= 0) return 0;
    if (nbp > 30) return fail(e, -6, "code-block with %d bit planes", nbp);
    t1->w = w;
    t1->h = h;
    t1->orient = B->orient;
    t1->vsc = (style & 0x08) != 0;
    t1->v = v;
    memset(t1->f, 0, (size_t)(w + 2) * (h + 2));
    c->data[c->len] = 0xFF;
    c->data[c->len + 1] = 0xFF;
    mq_init(&t1->mq, c->data, c->data + c->len);
    mq_reset_ctx(&t1->mq);
    int p = nbp - 1, kind = 2; /* 0 sig, 1 ref, 2 clean */
    for (int k = 0; k < c->passes && p >= 0; k++) {
        if (k && (style & 0x02)) mq_reset_ctx(&t1->mq);
        if (kind == 0) pass_sig(t1, p);
        else if (kind == 1) pass_ref(t1, p);
        else pass_clean(t1, p, (style & 0x20) != 0);
        if (kind == 2) { kind = 0; p--; }
        else kind++;
    }
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            if (FL(t1, x, y) & F_NEG) v[y * w + x] = -v[y * w + x];
    return 0;
}

/* ------------------------------------------------------------ inverse DWT */
static void idwt53_1d(int32_t *x, int n, int cas, int32_t *tmp) {
    if (n == 1) {
        if (cas) x[0] /= 2;
        return;
    }
    /* interleave: low half x[0..sn), high half x[sn..n) */
    int sn = cas ? n / 2 : (n + 1) / 2;
    for (int i = 0; i < n; i++) {
        int low = ((i + cas) & 1) == 0;
        tmp[i] = low ? x[(i - cas) / 2] : x[sn + (i + cas - 1) / 2];
    }
#define RF(i) tmp[(i) < 0 ? -(i) : (i) >= n ? 2 * (n - 1) - (i) : (i)]
    for (int i = 0; i < n; i++)
        if (((i + cas) & 1) == 0) tmp[i] -= (RF(i - 1) + RF(i + 1) + 2) >> 2;
    for (int i = 0; i < n; i++)
        if ((i + cas) & 1) tmp[i] += (RF(i - 1) + RF(i + 1)) >> 1;
#undef RF
    memcpy(x, tmp, sizeof(int32_t) * (size_t)n);
}

static const float ALPHA = -1.586134342f, BETA = -0.052980118f,
                   GAMMA = 0.882911075f, DELTA = 0.443506852f,
                   KK = 1.230174105f, TWO_INVK = 1.625732422f;

static void idwt97_1d(float *x, int n, int cas, float *tmp) {
    int sn = cas ? n / 2 : (n + 1) / 2, dn = n - sn;
    if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
    for (int i = 0; i < n; i++) {
        int low = ((i + cas) & 1) == 0;
        tmp[i] = low ? x[(i - cas) / 2] * KK
                     : x[sn + (i + cas - 1) / 2] * TWO_INVK;
    }
#define RF(i) tmp[(i) < 0 ? -(i) : (i) >= n ? 2 * (n - 1) - (i) : (i)]
    const float c[4] = {-DELTA, -GAMMA, -BETA, -ALPHA};
    for (int s = 0; s < 4; s++) {
        int par = s & 1; /* 0: low samples, 1: high samples */
        for (int i = 0; i < n; i++)
            if (((i + cas) & 1) == par) tmp[i] += (RF(i - 1) + RF(i + 1)) * c[s];
    }
#undef RF
    memcpy(x, tmp, sizeof(float) * (size_t)n);
}

/* ------------------------------------------------------- decode a tile */
static int decode_tile(Tile *t, const Image *im, int32_t *out, double *times,
                       Err *e) {
    int rc = tile_setup(t, im, e);
    if (rc) return rc;
    double t0 = now();
    rc = walk_tile(t, e);
    double t1 = now();
    times[0] += t1 - t0;
    if (rc) return rc;
    int64_t tw = t->x1 - t->x0, th = t->y1 - t->y0;
    if (tw <= 0 || th <= 0) return 0;
    int rev = t->st.rev;
    size_t npx = (size_t)tw * (size_t)th;
    int32_t *ibuf = rev ? calloc(npx, sizeof(int32_t)) : NULL;
    float *fbuf = rev ? NULL : calloc(npx, sizeof(float));
    int cbmax = 1 << (t->st.xcb + t->st.ycb);
    int32_t *cv = malloc(sizeof(int32_t) * (size_t)cbmax);
    T1 t1s;
    t1s.f = malloc((size_t)((1 << t->st.xcb) + 2) * ((1 << t->st.ycb) + 2));
    int64_t mx = tw > th ? tw : th;
    void *tmp = malloc(sizeof(int32_t) * (size_t)(mx + 2));
    void *col = malloc(sizeof(int32_t) * (size_t)(mx + 2));
    if ((!ibuf && !fbuf) || !cv || !t1s.f || !tmp || !col) {
        rc = fail(e, -4, "out of memory");
        goto out;
    }
    /* tier-1 and dequantization: each band into its quadrant of the
     * resolution's region (OpenJPEG's layout: low part at the origin) */
    for (int r = 0; r < t->nres && !rc; r++) {
        Res *R = &t->res[r];
        for (int pk = 0; pk < R->pw * R->ph && !rc; pk++)
            for (int bb = 0; bb < R->nb && !rc; bb++) {
                Band *B = &R->band[bb];
                PrecBand *pb = &R->prec[pk * R->nb + bb];
                int64_t ox = 0, oy = 0;
                if (r) {
                    Res *Rl = &t->res[r - 1];
                    if (B->orient & 1) ox = Rl->x1 - Rl->x0;
                    if (B->orient & 2) oy = Rl->y1 - Rl->y0;
                }
                for (int k = 0; k < pb->cw * pb->ch && !rc; k++) {
                    Cblk *c = &pb->cb[k];
                    rc = decode_cblk(c, B, t->st.style, &t1s, cv, e);
                    int w = (int)(c->x1 - c->x0), h = (int)(c->y1 - c->y0);
                    for (int y = 0; y < h && !rc; y++) {
                        size_t row = (size_t)(c->y0 - B->y0 + oy + y) * tw
                                     + (size_t)(c->x0 - B->x0 + ox);
                        for (int x = 0; x < w; x++) {
                            /* OpenJPEG's datap / 2 and datap * step / 2 */
                            int32_t m = cv[y * w + x];
                            if (rev) ibuf[row + x] = m / 2;
                            else fbuf[row + x] = (float)m * B->step;
                        }
                    }
                }
            }
    }
    double t2 = now();
    times[1] += t2 - t1;
    /* inverse DWT, resolution by resolution: rows, then columns */
    for (int r = 1; r < t->nres && !rc; r++) {
        Res *R = &t->res[r];
        int rw = (int)(R->x1 - R->x0), rh = (int)(R->y1 - R->y0);
        int cx = (int)(R->x0 & 1), cy = (int)(R->y0 & 1);
        if (!rw || !rh) continue;
        for (int y = 0; y < rh; y++) {
            if (rev) idwt53_1d(ibuf + (size_t)y * tw, rw, cx, tmp);
            else idwt97_1d(fbuf + (size_t)y * tw, rw, cx, tmp);
        }
        for (int x = 0; x < rw; x++) {
            if (rev) {
                int32_t *cc = col;
                for (int y = 0; y < rh; y++) cc[y] = ibuf[(size_t)y * tw + x];
                idwt53_1d(cc, rh, cy, tmp);
                for (int y = 0; y < rh; y++) ibuf[(size_t)y * tw + x] = cc[y];
            } else {
                float *cc = col;
                for (int y = 0; y < rh; y++) cc[y] = fbuf[(size_t)y * tw + x];
                idwt97_1d(cc, rh, cy, tmp);
                for (int y = 0; y < rh; y++) fbuf[(size_t)y * tw + x] = cc[y];
            }
        }
    }
    times[2] += now() - t2;
    if (rc) goto out;
    /* DC level shift, clamp, into the image */
    int64_t lo = im->sgnd ? -((int64_t)1 << (im->prec - 1)) : 0;
    int64_t hi = im->sgnd ? ((int64_t)1 << (im->prec - 1)) - 1
                          : ((int64_t)1 << im->prec) - 1;
    int64_t shift = im->sgnd ? 0 : (int64_t)1 << (im->prec - 1);
    int64_t W = im->x1 - im->x0;
    for (int64_t y = 0; y < th; y++)
        for (int64_t x = 0; x < tw; x++) {
            int64_t v;
            if (rev) {
                v = (int64_t)ibuf[y * tw + x] + shift;
            } else {
                float f = fbuf[y * tw + x];
                if (f > 2147483647.0f) v = hi;
                else if (f < -2147483648.0f) v = lo;
                else v = (int64_t)lrintf(f) + shift;
            }
            v = v < lo ? lo : v > hi ? hi : v;
            out[(t->y0 + y - im->y0) * W + (t->x0 + x - im->x0)] = (int32_t)v;
        }
out:
    free(ibuf);
    free(fbuf);
    free(cv);
    free(t1s.f);
    free(tmp);
    free(col);
    return rc;
}

/* ------------------------------------------------------ main header walk */
static int parse_main(const uint8_t *d, size_t n, Image *im, size_t *first,
                      Err *e) {
    Rd r = {d, n, 0};
    unsigned m;
    if (rd16(&r, &m) || m != 0xFF4F) return fail(e, -1, "no SOC marker");
    memset(im, 0, sizeof *im);
    int have_siz = 0;
    for (;;) {
        size_t at = r.i;
        unsigned len;
        if (rd16(&r, &m)) return fail(e, -2, "main header ends early");
        if (m == 0xFF90) { /* SOT: the first tile-part */
            if (!have_siz || !im->have_cod || !im->have_qcd)
                return fail(e, -2, "main header lacks SIZ, COD or QCD");
            *first = at;
            return 0;
        }
        if (m < 0xFF30 || m == 0xFFD9)
            return fail(e, -2, "unexpected marker 0x%04X in the main header",
                        m);
        if (rd16(&r, &len) || len < 2 || r.i + len - 2 > n)
            return fail(e, -2, "marker 0x%04X overruns the stream", m);
        size_t end = r.i + len - 2;
        Rd s = {d, end, r.i};
        if (m == 0xFF51) { /* SIZ */
            unsigned rsiz, csiz, ss, xr, yr;
            uint32_t v[8];
            if (rd16(&s, &rsiz)) return fail(e, -2, "truncated SIZ");
            for (int k = 0; k < 8; k++)
                if (rd32(&s, &v[k])) return fail(e, -2, "truncated SIZ");
            if (rd16(&s, &csiz)) return fail(e, -2, "truncated SIZ");
            if (csiz != 1)
                return fail(e, -3, "%u components: multiple components not "
                            "taken", csiz);
            if (rd8(&s, &ss) || rd8(&s, &xr) || rd8(&s, &yr))
                return fail(e, -2, "truncated SIZ");
            if (xr != 1 || yr != 1)
                return fail(e, -3, "subsampled component (%u x %u) not "
                            "taken", xr, yr);
            im->x1 = v[0];
            im->y1 = v[1];
            im->x0 = v[2];
            im->y0 = v[3];
            im->tw = v[4];
            im->th = v[5];
            im->tx0 = v[6];
            im->ty0 = v[7];
            im->prec = (int)(ss & 0x7F) + 1;
            im->sgnd = (int)(ss >> 7);
            if (im->prec > 16) return fail(e, -3, "precision %d above 16",
                                           im->prec);
            if (im->x0 >= im->x1 || im->y0 >= im->y1 || !im->tw || !im->th
                || im->tx0 > im->x0 || im->ty0 > im->y0
                || im->tx0 + im->tw <= im->x0 || im->ty0 + im->th <= im->y0)
                return fail(e, -2, "bad image or tile geometry");
            /* the output is allocated from these before any tile is read:
               a claim above a product's size is refused, so a corrupt SIZ
               cannot exhaust memory (each side then also fits an int) */
            if ((im->x1 - im->x0) * (im->y1 - im->y0) > J2K_MAX_PIXELS)
                return fail(e, -2, "image of %lld x %lld above the %lld "
                            "pixels taken", (long long)(im->x1 - im->x0),
                            (long long)(im->y1 - im->y0),
                            (long long)J2K_MAX_PIXELS);
            im->ntx = (int)ceildiv(im->x1 - im->tx0, im->tw);
            im->nty = (int)ceildiv(im->y1 - im->ty0, im->th);
            if ((int64_t)im->ntx * im->nty > 65535)
                return fail(e, -2, "too many tiles");
            have_siz = 1;
        } else if (m == 0xFF52) {
            int rc = parse_cod(&s, &im->def, e);
            if (rc) return rc;
            im->have_cod = 1;
        } else if (m == 0xFF53) { /* COC: the one component's coding */
            unsigned c, sc;
            if (rd8(&s, &c) || rd8(&s, &sc)) return fail(e, -2, "bad COC");
            if (c) return fail(e, -2, "COC for component %u", c);
            int rc = parse_cod_sp(&s, &im->def, (int)sc, e);
            if (rc) return rc;
        } else if (m == 0xFF5C || m == 0xFF5D) {
            if (m == 0xFF5D) {
                unsigned c;
                if (rd8(&s, &c) || c) return fail(e, -2, "bad QCC");
            }
            int rc = parse_qcd(&s, end, &im->def, e);
            if (rc) return rc;
            im->have_qcd = 1;
        } else if (m == 0xFF5E) {
            return fail(e, -3, "region of interest (RGN) not taken");
        } else if (m == 0xFF5F) {
            return fail(e, -3, "progression order change (POC) not taken");
        } else if (m == 0xFF60 || m == 0xFF61) {
            return fail(e, -3, "packed packet headers (PPM/PPT) not taken");
        } /* TLM, PLM, CRG, COM and the rest: skipped */
        r.i = end;
    }
}

int j2k_header(const uint8_t *d, size_t n, int *w, int *h, int *prec,
               int *sgnd, char *err, int errlen) {
    Err e = {err, errlen};
    size_t off, len, first;
    Image im;
    int rc = find_codestream(d, n, &off, &len, &e);
    if (rc) return rc;
    rc = parse_main(d + off, len, &im, &first, &e);
    if (rc) return rc;
    *w = (int)(im.x1 - im.x0);
    *h = (int)(im.y1 - im.y0);
    *prec = im.prec;
    *sgnd = im.sgnd;
    return 0;
}

int j2k_decode(const uint8_t *d0, size_t n0, int32_t *out, size_t cap,
               double *times, char *err, int errlen) {
    Err e = {err, errlen};
    size_t off, n, pos;
    Image im;
    int rc = find_codestream(d0, n0, &off, &n, &e);
    if (rc) return rc;
    const uint8_t *d = d0 + off;
    rc = parse_main(d, n, &im, &pos, &e);
    if (rc) return rc;
    int64_t W = im.x1 - im.x0, H = im.y1 - im.y0;
    if ((size_t)(W * H) > cap) return fail(&e, -7, "output buffer too small");
    for (int64_t i = 0; i < W * H; i++)
        out[i] = im.sgnd ? 0 : (int32_t)1 << (im.prec - 1);
    int nt = im.ntx * im.nty;
    Tile *tiles = calloc((size_t)nt, sizeof(Tile));
    if (!tiles) return fail(&e, -4, "out of memory");
    /* tile-parts: gather each tile's header and bit stream */
    while (pos + 2 <= n) {
        Rd r = {d, n, pos};
        unsigned m, len, isot, tp, ntp;
        uint32_t psot;
        if (rd16(&r, &m)) break;
        if (m == 0xFFD9) break;
        if (m != 0xFF90) { rc = fail(&e, -2, "expected SOT, found 0x%04X", m);
                           goto done; }
        if (rd16(&r, &len) || len != 10 || rd16(&r, &isot) || rd32(&r, &psot)
            || rd8(&r, &tp) || rd8(&r, &ntp)) {
            rc = fail(&e, -2, "bad SOT segment");
            goto done;
        }
        if ((int)isot >= nt) { rc = fail(&e, -2, "tile %u of %d", isot, nt);
                               goto done; }
        size_t tend = psot ? pos + psot : n;
        if (psot && (psot < 14 || tend > n)) {
            if (psot >= 14 && tend > n) tend = n; /* truncated: keep it */
            else { rc = fail(&e, -2, "bad tile-part length"); goto done; }
        }
        Tile *t = &tiles[isot];
        if (!t->seen) {
            t->seen = 1;
            t->st = im.def;
            int p = (int)(isot % im.ntx), q = (int)(isot / im.ntx);
            t->x0 = im.tx0 + p * im.tw;
            t->y0 = im.ty0 + q * im.th;
            t->x1 = t->x0 + im.tw;
            t->y1 = t->y0 + im.th;
            if (t->x0 < im.x0) t->x0 = im.x0;
            if (t->y0 < im.y0) t->y0 = im.y0;
            if (t->x1 > im.x1) t->x1 = im.x1;
            if (t->y1 > im.y1) t->y1 = im.y1;
        }
        /* tile-part header up to SOD */
        for (;;) {
            if (rd16(&r, &m) || r.i > tend) {
                rc = fail(&e, -2, "tile-part header ends early");
                goto done;
            }
            if (m == 0xFF93) break;
            if (rd16(&r, &len) || len < 2 || r.i + len - 2 > tend) {
                rc = fail(&e, -2, "marker 0x%04X overruns the tile-part", m);
                goto done;
            }
            size_t end = r.i + len - 2;
            Rd s = {d, end, r.i};
            if (m == 0xFF52) {
                rc = parse_cod(&s, &t->st, &e);
            } else if (m == 0xFF53) {
                unsigned c, sc;
                if (rd8(&s, &c) || rd8(&s, &sc) || c)
                    rc = fail(&e, -2, "bad COC");
                else rc = parse_cod_sp(&s, &t->st, (int)sc, &e);
            } else if (m == 0xFF5C || m == 0xFF5D) {
                unsigned c;
                if (m == 0xFF5D && (rd8(&s, &c) || c))
                    rc = fail(&e, -2, "bad QCC");
                else rc = parse_qcd(&s, end, &t->st, &e);
            } else if (m == 0xFF5E) {
                rc = fail(&e, -3, "region of interest (RGN) not taken");
            } else if (m == 0xFF5F) {
                rc = fail(&e, -3, "progression order change (POC) not taken");
            } else if (m == 0xFF61) {
                rc = fail(&e, -3, "packed packet headers (PPT) not taken");
            }
            if (rc) goto done;
            r.i = end;
        }
        if (append(&t->data, &t->len, &t->cap, d + r.i, tend - r.i)) {
            rc = fail(&e, -4, "out of memory");
            goto done;
        }
        pos = tend;
    }
    for (int k = 0; k < nt && !rc; k++) {
        if (!tiles[k].seen) continue;
        rc = decode_tile(&tiles[k], &im, out, times, &e);
        tile_free(&tiles[k]);
    }
done:
    for (int k = 0; k < nt; k++) tile_free(&tiles[k]);
    free(tiles);
    return rc;
}

/* ================================================================ encoder
 *
 * j2k_encode writes one 8- or 16-bit component as a JP2 file with the
 * coding parameters that OpenJPEG (through Pillow) writes by default: one
 * tile, LRCP, one quality layer, no MCT, 64 x 64 code-blocks, no
 * precincts, no SOP / EPH, code-block style 0, min(5, floor(log2(min(w,
 * h)))) decomposition levels, guard bits 2; the reversible 5/3 without
 * quantization or the irreversible 9/7 with OpenJPEG's step sizes. Every
 * coding pass of every code-block goes into the one layer (no rate
 * control). The forward transforms are the exact inverses of the
 * decoder's (the 9/7's scaling included), so a lossless stream decodes to
 * the input and a 9/7 one to within its quantization.
 */

/* a growable byte buffer */
typedef struct {
    uint8_t *d;
    size_t n, cap;
    int oom;
} Buf;

static int buf_reserve(Buf *b, size_t more) {
    if (b->oom) return -1;
    if (b->n + more <= b->cap) return 0;
    size_t c = b->cap ? b->cap : 256;
    while (b->n + more > c) c *= 2;
    uint8_t *nd = realloc(b->d, c);
    if (!nd) { b->oom = 1; return -1; }
    b->d = nd;
    b->cap = c;
    return 0;
}

static void put8(Buf *b, unsigned v) {
    if (!buf_reserve(b, 1)) b->d[b->n++] = (uint8_t)v;
}
static void put16(Buf *b, unsigned v) { put8(b, v >> 8); put8(b, v & 0xFF); }
static void put32(Buf *b, uint32_t v) { put16(b, v >> 16); put16(b, v & 0xFFFF); }
static void putn(Buf *b, const void *src, size_t n) {
    if (n && !buf_reserve(b, n)) {
        memcpy(b->d + b->n, src, n);
        b->n += n;
    }
}

/* ---------------------------------------------------- the MQ encoder (C.2) */
typedef struct {
    uint32_t a, c;
    int ct;
    Buf *out;          /* out->d[0] is a zero byte ahead of the data */
    uint8_t idx[NCTX], mps[NCTX];
} MQE;

static void mqe_reset_ctx(MQE *m) {
    memset(m->idx, 0, sizeof m->idx);
    memset(m->mps, 0, sizeof m->mps);
    m->idx[CTX_UNI] = 46;
    m->idx[CTX_RL] = 3;
    m->idx[0] = 4;
}

static void mqe_init(MQE *m, Buf *out) {
    m->a = 0x8000;
    m->c = 0;
    m->ct = 12;
    m->out = out;
    out->n = 0;
    put8(out, 0);       /* the byte "before" the data: never 0xFF */
}

/* the last byte written (the zero byte ahead of the data at first) */
#define MQ_B(m) ((m)->out->d[(m)->out->n - 1])

static void mqe_byteout(MQE *m) {
    if (m->out->oom) return;
    if (MQ_B(m) == 0xFF) {
        put8(m->out, m->c >> 20);
        m->c &= 0xFFFFF;
        m->ct = 7;
    } else if (!(m->c & 0x8000000)) {
        put8(m->out, m->c >> 19);
        m->c &= 0x7FFFF;
        m->ct = 8;
    } else {
        MQ_B(m)++;                        /* the carry */
        if (MQ_B(m) == 0xFF) {
            m->c &= 0x7FFFFFF;
            put8(m->out, m->c >> 20);
            m->c &= 0xFFFFF;
            m->ct = 7;
        } else {
            put8(m->out, m->c >> 19);
            m->c &= 0x7FFFF;
            m->ct = 8;
        }
    }
}

static void mqe_renorm(MQE *m) {
    do {
        m->a <<= 1;
        m->c <<= 1;
        if (!--m->ct) mqe_byteout(m);
    } while (!(m->a & 0x8000));
}

static void mqe_encode(MQE *m, int cx, int d) {
    int i = m->idx[cx];
    uint32_t qe = QE[i];
    m->a -= qe;
    if (d == m->mps[cx]) {                /* CODEMPS */
        if (m->a & 0x8000) {
            m->c += qe;
            return;
        }
        if (m->a < qe) m->a = qe;
        else m->c += qe;
        m->idx[cx] = NMPS[i];
    } else {                              /* CODELPS */
        if (m->a < qe) m->c += qe;
        else m->a = qe;
        if (SWITCH[i]) m->mps[cx] = (uint8_t)(1 - m->mps[cx]);
        m->idx[cx] = NLPS[i];
    }
    mqe_renorm(m);
}

/* FLUSH (C.2.9); returns the code-block's bytes (a last 0xFF dropped) */
static size_t mqe_flush(MQE *m) {
    uint32_t t = m->c + m->a;             /* SETBITS */
    m->c |= 0xFFFF;
    if (m->c >= t) m->c -= 0x8000;
    m->c <<= m->ct;
    mqe_byteout(m);
    m->c <<= m->ct;
    mqe_byteout(m);
    size_t n = m->out->n - 1;
    if (n && m->out->d[m->out->n - 1] == 0xFF) n--;
    return n;
}

/* ------------------------------------------- tier-1: EBCOT's passes (D) */
typedef struct {
    T1 t;                 /* the flags, the geometry and the contexts */
    const uint32_t *mag;  /* |coefficient| of each sample */
    MQE mq;
} T1E;

#define EBIT(e, x, y, p) ((int)(((e)->mag[(y) * (e)->t.w + (x)] >> (p)) & 1))

static void enc_sig(T1E *e, int x, int y) {
    T1 *t = &e->t;
    int xr, ctx = sign_ctx(t, x, y, &xr);
    int neg = (FL(t, x, y) & F_NEG) != 0;
    mqe_encode(&e->mq, ctx, neg ^ xr);
    FL(t, x, y) |= F_SIG;
}

static void enc_pass_sig(T1E *e, int p) {
    T1 *t = &e->t;
    for (int y0 = 0; y0 < t->h; y0 += 4)
        for (int x = 0; x < t->w; x++)
            for (int y = y0; y < y0 + 4 && y < t->h; y++) {
                uint8_t *f = &FL(t, x, y);
                if ((*f & F_SIG) || !any_sig(t, x, y)) continue;
                *f |= F_VIS;
                int b = EBIT(e, x, y, p);
                mqe_encode(&e->mq, zc_ctx(t, x, y), b);
                if (b) enc_sig(e, x, y);
            }
}

static void enc_pass_ref(T1E *e, int p) {
    T1 *t = &e->t;
    for (int y0 = 0; y0 < t->h; y0 += 4)
        for (int x = 0; x < t->w; x++)
            for (int y = y0; y < y0 + 4 && y < t->h; y++) {
                uint8_t *f = &FL(t, x, y);
                if ((*f & (F_SIG | F_VIS)) != F_SIG) continue;
                int ctx = (*f & F_REF) ? 16 : any_sig(t, x, y) ? 15 : 14;
                mqe_encode(&e->mq, ctx, EBIT(e, x, y, p));
                *f |= F_REF;
            }
}

static void enc_pass_clean(T1E *e, int p) {
    T1 *t = &e->t;
    for (int y0 = 0; y0 < t->h; y0 += 4)
        for (int x = 0; x < t->w; x++) {
            int y = y0;
            if (y0 + 4 <= t->h) {
                int rl = 1;
                for (int k = 0; k < 4 && rl; k++)
                    if ((FL(t, x, y0 + k) & (F_SIG | F_VIS))
                        || any_sig(t, x, y0 + k))
                        rl = 0;
                if (rl) {
                    int r = 0;
                    while (r < 4 && !EBIT(e, x, y0 + r, p)) r++;
                    mqe_encode(&e->mq, CTX_RL, r < 4);
                    if (r == 4) continue;
                    mqe_encode(&e->mq, CTX_UNI, r >> 1);
                    mqe_encode(&e->mq, CTX_UNI, r & 1);
                    y = y0 + r;
                    enc_sig(e, x, y);
                    y++;
                }
            }
            for (; y < y0 + 4 && y < t->h; y++) {
                uint8_t *f = &FL(t, x, y);
                if (*f & (F_SIG | F_VIS)) continue;
                int b = EBIT(e, x, y, p);
                mqe_encode(&e->mq, zc_ctx(t, x, y), b);
                if (b) enc_sig(e, x, y);
            }
        }
    for (int y = 0; y < t->h; y++)
        for (int x = 0; x < t->w; x++) FL(t, x, y) &= (uint8_t)~F_VIS;
}

/* one code-block of w x h magnitudes and signs (1: negative): all its
 * passes into c->data; c->passes 0 when every magnitude is 0 */
static int encode_cblk(Cblk *c, const Band *B, T1E *e, const uint32_t *mag,
                       const uint8_t *neg, int w, int h, Buf *mqbuf,
                       Err *err) {
    uint32_t mx = 0;
    for (int i = 0; i < w * h; i++) mx |= mag[i];
    int nbp = 0;
    while (nbp < 32 && (mx >> nbp)) nbp++;
    c->passes = 0;
    c->len = 0;
    if (!nbp) return 0;
    if (nbp > B->mb)
        return fail(err, -8, "a coefficient needs %d magnitude bit planes "
                    "of the band's %d", nbp, B->mb);
    c->zbp = B->mb - nbp;
    T1 *t = &e->t;
    t->w = w;
    t->h = h;
    t->orient = B->orient;
    t->vsc = 0;
    e->mag = mag;
    memset(t->f, 0, (size_t)(w + 2) * (h + 2));
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            if (neg[y * w + x]) FL(t, x, y) |= F_NEG;
    mqe_init(&e->mq, mqbuf);
    mqe_reset_ctx(&e->mq);
    enc_pass_clean(e, nbp - 1);
    for (int p = nbp - 2; p >= 0; p--) {
        enc_pass_sig(e, p);
        enc_pass_ref(e, p);
        enc_pass_clean(e, p);
    }
    size_t n = mqe_flush(&e->mq);
    if (mqbuf->oom) return fail(err, -4, "out of memory");
    c->passes = 3 * nbp - 2;
    c->data = malloc(n ? n : 1);
    if (!c->data) return fail(err, -4, "out of memory");
    memcpy(c->data, mqbuf->d + 1, n);
    c->len = n;
    c->cap = n;
    return 0;
}

/* -------------------------------------------- tier-2: packet headers (B) */
typedef struct {
    Buf *out;
    unsigned buf;
    int ct;
} BioW;

static void biow_byteout(BioW *b) {
    b->buf = (b->buf << 8) & 0xFFFF;
    b->ct = b->buf == 0xFF00 ? 7 : 8;   /* a bit stuffed after 0xFF */
    put8(b->out, b->buf >> 8);
}

static void biow_bit(BioW *b, int v) {
    if (!b->ct) biow_byteout(b);
    b->ct--;
    b->buf |= (unsigned)(v & 1) << b->ct;
}

static void biow_bits(BioW *b, unsigned v, int n) {
    while (n--) biow_bit(b, (int)((v >> n) & 1));
}

static void biow_flush(BioW *b) {
    biow_byteout(b);
    if (b->ct == 7) biow_byteout(b);    /* never end on 0xFF */
}

/* the tag tree's nodes above the leaves: the least of their children */
static int tag_fill(Tag *t, const int *leaves) {
    t->known = calloc((size_t)(t->n ? t->n : 1), 1);
    if (!t->known) return -1;
    for (int i = 0; i < t->w * t->h; i++) t->val[i] = leaves[i];
    for (int l = 1; l < t->nlev; l++)
        for (int y = 0; y < t->lh[l]; y++)
            for (int x = 0; x < t->lw[l]; x++) {
                int m = 1 << 30;
                for (int dy = 0; dy < 2; dy++)
                    for (int dx = 0; dx < 2; dx++) {
                        int cx = 2 * x + dx, cy = 2 * y + dy;
                        if (cx >= t->lw[l - 1] || cy >= t->lh[l - 1]) continue;
                        int v = t->val[t->off[l - 1] + cy * t->lw[l - 1] + cx];
                        if (v < m) m = v;
                    }
                t->val[t->off[l] + y * t->lw[l] + x] = m;
            }
    return 0;
}

/* the leaf's value against thresholds up to thr (B.10.2), root first */
static void tag_encode(Tag *t, BioW *b, int leaf, int thr) {
    int path[40];
    int x = leaf % t->w, y = leaf / t->w;
    for (int l = 0; l < t->nlev; l++) {
        path[l] = t->off[l] + y * t->lw[l] + x;
        x >>= 1;
        y >>= 1;
    }
    int low = 0;
    for (int l = t->nlev - 1; l >= 0; l--) {
        int k = path[l];
        if (low > t->low[k]) t->low[k] = low;
        else low = t->low[k];
        while (low < thr) {
            if (low >= t->val[k]) {
                if (!t->known[k]) {
                    biow_bit(b, 1);
                    t->known[k] = 1;
                }
                break;
            }
            biow_bit(b, 0);
            low++;
        }
        t->low[k] = low;
    }
}

static void put_passes(BioW *b, int n) {
    if (n == 1) biow_bits(b, 0, 1);
    else if (n == 2) biow_bits(b, 2, 2);
    else if (n <= 5) biow_bits(b, 0xC | (unsigned)(n - 3), 4);
    else if (n <= 36) biow_bits(b, 0x1E0 | (unsigned)(n - 6), 9);
    else biow_bits(b, 0xFF80 | (unsigned)(n - 37), 16);
}

/* the one layer's packet of (resolution r, precinct k) */
static int write_packet(Tile *t, int r, int k, Buf *out, Err *e) {
    Res *R = &t->res[r];
    BioW b = {out, 0, 8};
    int any = 0;
    for (int bb = 0; bb < R->nb; bb++) {
        PrecBand *pb = &R->prec[k * R->nb + bb];
        for (int i = 0; i < pb->cw * pb->ch; i++) any |= pb->cb[i].passes > 0;
    }
    biow_bit(&b, any);
    for (int bb = 0; any && bb < R->nb; bb++) {
        PrecBand *pb = &R->prec[k * R->nb + bb];
        int ncb = pb->cw * pb->ch;
        if (!ncb) continue;
        int *leaves = malloc(sizeof(int) * (size_t)ncb);
        if (!leaves) return fail(e, -4, "out of memory");
        for (int i = 0; i < ncb; i++) leaves[i] = pb->cb[i].passes ? 0 : 1;
        int rc = tag_fill(&pb->incl, leaves);
        for (int i = 0; i < ncb && !rc; i++)
            leaves[i] = pb->cb[i].passes ? pb->cb[i].zbp : R->band[bb].mb;
        if (!rc) rc = tag_fill(&pb->zbp, leaves);
        free(leaves);
        if (rc) return fail(e, -4, "out of memory");
        for (int i = 0; i < ncb; i++) {
            Cblk *c = &pb->cb[i];
            tag_encode(&pb->incl, &b, i, 1);
            if (!c->passes) continue;
            tag_encode(&pb->zbp, &b, i, c->zbp + 1);
            put_passes(&b, c->passes);
            int fl = floorlog2((unsigned)c->passes);
            while ((uint64_t)c->len >> (c->lblock + fl)) {
                biow_bit(&b, 1);
                c->lblock++;
            }
            biow_bit(&b, 0);
            biow_bits(&b, (unsigned)c->len, c->lblock + fl);
        }
    }
    biow_flush(&b);
    for (int bb = 0; any && bb < R->nb; bb++) {
        PrecBand *pb = &R->prec[k * R->nb + bb];
        for (int i = 0; i < pb->cw * pb->ch; i++)
            putn(out, pb->cb[i].data, pb->cb[i].len);
    }
    return out->oom ? fail(e, -4, "out of memory") : 0;
}

/* ----------------------------------------------------- forward DWT (F.4) */
/* one line of n samples, interleaved in place (cas 0), then the low half
 * ahead of the high half */
static void fdwt53_1d(int32_t *x, int n, int32_t *tmp) {
    if (n < 2) return;
#define XF(i) x[(i) < 0 ? -(i) : (i) >= n ? 2 * (n - 1) - (i) : (i)]
    for (int i = 1; i < n; i += 2) x[i] -= (XF(i - 1) + XF(i + 1)) >> 1;
    for (int i = 0; i < n; i += 2) x[i] += (XF(i - 1) + XF(i + 1) + 2) >> 2;
#undef XF
    int sn = (n + 1) / 2;
    for (int i = 0; i < n; i++) tmp[(i & 1) ? sn + i / 2 : i / 2] = x[i];
    memcpy(x, tmp, sizeof(int32_t) * (size_t)n);
}

static void fdwt97_1d(float *x, int n, float *tmp) {
    if (n < 2) return;
#define XF(i) x[(i) < 0 ? -(i) : (i) >= n ? 2 * (n - 1) - (i) : (i)]
    const float c[4] = {ALPHA, BETA, GAMMA, DELTA};
    for (int s = 0; s < 4; s++)
        for (int i = (s & 1) ? 0 : 1; i < n; i += 2)
            x[i] += (XF(i - 1) + XF(i + 1)) * c[s];
#undef XF
    int sn = (n + 1) / 2;
    for (int i = 0; i < n; i++)
        tmp[(i & 1) ? sn + i / 2 : i / 2] = (i & 1) ? x[i] / TWO_INVK
                                                    : x[i] / KK;
    memcpy(x, tmp, sizeof(float) * (size_t)n);
}

/* NL levels over the (h, w) plane: columns, then rows, each level on the
 * previous level's low part (the decoder's layout) */
static void fdwt(void *plane, int w, int h, int nl, int rev, void *tmp,
                 void *col) {
    for (int l = 0; l < nl; l++) {
        int rw = (int)ceilpow2(w, l), rh = (int)ceilpow2(h, l);
        for (int x = 0; x < rw; x++) {
            if (rev) {
                int32_t *p = plane, *cc = col;
                for (int y = 0; y < rh; y++) cc[y] = p[(size_t)y * w + x];
                fdwt53_1d(cc, rh, tmp);
                for (int y = 0; y < rh; y++) p[(size_t)y * w + x] = cc[y];
            } else {
                float *p = plane, *cc = col;
                for (int y = 0; y < rh; y++) cc[y] = p[(size_t)y * w + x];
                fdwt97_1d(cc, rh, tmp);
                for (int y = 0; y < rh; y++) p[(size_t)y * w + x] = cc[y];
            }
        }
        for (int y = 0; y < rh; y++) {
            if (rev) fdwt53_1d((int32_t *)plane + (size_t)y * w, rw, tmp);
            else fdwt97_1d((float *)plane + (size_t)y * w, rw, tmp);
        }
    }
}

/* --------------------------------------------- quantization step sizes */
/* OpenJPEG 2.5.4's 9/7 step sizes (its opj_dwt_calc_explicit_stepsizes),
 * as (exponent - precision + 8, mantissa): read off the QCD segments that
 * Pillow 12.1 writes for 8- and 16-bit images of 1 to 5 levels (the
 * exponent moves with the precision, the mantissa does not). The LL band
 * by the number of levels; the detail bands by their level (1: the
 * finest), HL and LH alike, then HH. */
static const uint8_t Q97_LL_E[6] = {8, 9, 11, 12, 13, 14};
static const uint16_t Q97_LL_M[6] = {0, 36, 1874, 1848, 1824, 1824};
static const uint8_t Q97_D_E[5][2] = {{10, 10}, {10, 10}, {12, 12},
                                      {13, 13}, {14, 14}};
static const uint16_t Q97_D_M[5][2] = {{2003, 1890}, {5, 71}, {1872, 1896},
                                       {1792, 1760}, {1776, 1728}};
#define ENC_MAXNL 5

static void enc_style(Style *s, int nl, int rev, int prec) {
    memset(s, 0, sizeof *s);
    s->nl = nl;
    s->xcb = s->ycb = 6;
    s->rev = rev;
    for (int r = 0; r <= nl; r++) s->ppx[r] = s->ppy[r] = 15;
    s->layers = 1;
    s->guard = 2;
    s->qstyle = rev ? 0 : 2;
    s->nq = 3 * nl + 1;
    for (int k = 0; k < s->nq; k++) {
        int r = k ? (k - 1) / 3 + 1 : 0, b = k ? (k - 1) % 3 : 0;
        if (rev) {   /* no quantization: precision + the band's gain */
            s->eps[k] = prec + (r ? (b == 2 ? 2 : 1) : 0);
        } else if (!r) {
            s->eps[k] = prec - 8 + Q97_LL_E[nl];
            s->mu[k] = Q97_LL_M[nl];
        } else {
            int lev = nl - r + 1, hh = b == 2;
            s->eps[k] = prec - 8 + Q97_D_E[lev - 1][hh];
            s->mu[k] = Q97_D_M[lev - 1][hh];
        }
    }
}

/* ------------------------------------------------------------- the file */
static void put_codestream_header(Buf *o, const Style *s, int w, int h,
                                  int prec) {
    put16(o, 0xFF4F);                     /* SOC */
    put16(o, 0xFF51);                     /* SIZ */
    put16(o, 41);
    put16(o, 0);
    put32(o, (uint32_t)w);
    put32(o, (uint32_t)h);
    put32(o, 0);
    put32(o, 0);
    put32(o, (uint32_t)w);                /* one tile */
    put32(o, (uint32_t)h);
    put32(o, 0);
    put32(o, 0);
    put16(o, 1);
    put8(o, (unsigned)(prec - 1));
    put8(o, 1);
    put8(o, 1);
    put16(o, 0xFF52);                     /* COD */
    put16(o, 12);
    put8(o, 0);                           /* no precincts, SOP or EPH */
    put8(o, 0);                           /* LRCP */
    put16(o, 1);                          /* one layer */
    put8(o, 0);                           /* no MCT */
    put8(o, (unsigned)s->nl);
    put8(o, (unsigned)(s->xcb - 2));
    put8(o, (unsigned)(s->ycb - 2));
    put8(o, 0);                           /* code-block style */
    put8(o, (unsigned)s->rev);
    put16(o, 0xFF5C);                     /* QCD */
    put16(o, (unsigned)(3 + (s->rev ? 1 : 2) * s->nq));
    put8(o, (unsigned)(s->guard << 5 | s->qstyle));
    for (int k = 0; k < s->nq; k++) {
        if (s->rev) put8(o, (unsigned)(s->eps[k] << 3));
        else put16(o, (unsigned)(s->eps[k] << 11 | s->mu[k]));
    }
}

static void put_jp2_header(Buf *o, int w, int h, int prec, size_t cslen) {
    static const uint8_t sig[12] = {0, 0, 0, 12, 'j', 'P', ' ', ' ',
                                    0x0D, 0x0A, 0x87, 0x0A};
    putn(o, sig, 12);
    put32(o, 20);
    putn(o, "ftypjp2 ", 8);
    put32(o, 0);
    putn(o, "jp2 ", 4);
    put32(o, 45);
    putn(o, "jp2h", 4);
    put32(o, 22);
    putn(o, "ihdr", 4);
    put32(o, (uint32_t)h);
    put32(o, (uint32_t)w);
    put16(o, 1);                          /* one component */
    put8(o, (unsigned)(prec - 1));
    put8(o, 7);                           /* compression: JPEG 2000 */
    put8(o, 0);
    put8(o, 0);
    put32(o, 15);
    putn(o, "colr", 4);
    put8(o, 1);                           /* enumerated */
    put8(o, 0);
    put8(o, 0);
    put32(o, 17);                         /* greyscale */
    put32(o, (uint32_t)(8 + cslen));
    putn(o, "jp2c", 4);
}

/* img: (h, w) samples, uint8 (prec 8) or uint16 (prec 16), row-major.
 * *out (freed by j2k_free) holds *outlen bytes of a JP2 file. */
int j2k_encode(const void *img, int w, int h, int prec, int lossless,
               uint8_t **out, size_t *outlen, char *err, int errlen) {
    Err e = {err, errlen};
    *out = NULL;
    *outlen = 0;
    if (prec != 8 && prec != 16) return fail(&e, -3, "precision %d", prec);
    if (w < 1 || h < 1 || (int64_t)w * h > J2K_MAX_PIXELS)
        return fail(&e, -2, "image of %d x %d", w, h);
    int m = w < h ? w : h, nl = floorlog2((unsigned)m);
    if (nl > ENC_MAXNL) nl = ENC_MAXNL;
    int rev = lossless != 0;
    Image im;
    memset(&im, 0, sizeof im);
    im.x1 = w;
    im.y1 = h;
    im.tw = w;
    im.th = h;
    im.prec = prec;
    im.ntx = im.nty = 1;
    enc_style(&im.def, nl, rev, prec);
    Tile t;
    memset(&t, 0, sizeof t);
    t.x1 = w;
    t.y1 = h;
    t.st = im.def;
    size_t npx = (size_t)w * h, mx = (size_t)(w > h ? w : h);
    int32_t *ibuf = rev ? malloc(npx * sizeof(int32_t)) : NULL;
    float *fbuf = rev ? NULL : malloc(npx * sizeof(float));
    void *tmp = malloc((mx + 2) * sizeof(int32_t));
    void *col = malloc((mx + 2) * sizeof(int32_t));
    uint32_t *mag = malloc(64 * 64 * sizeof(uint32_t));
    uint8_t *neg = malloc(64 * 64);
    T1E t1;
    memset(&t1, 0, sizeof t1);
    t1.t.f = malloc(66 * 66);
    Buf mqbuf = {0}, o = {0}, body = {0};
    int rc = 0;
    if ((!ibuf && !fbuf) || !tmp || !col || !mag || !neg || !t1.t.f) {
        rc = fail(&e, -4, "out of memory");
        goto done;
    }
    rc = tile_setup(&t, &im, &e);
    if (rc) goto done;
    /* DC level shift, forward DWT */
    int32_t shift = 1 << (prec - 1);
    for (size_t i = 0; i < npx; i++) {
        int32_t v = prec == 8 ? ((const uint8_t *)img)[i]
                              : ((const uint16_t *)img)[i];
        if (rev) ibuf[i] = v - shift;
        else fbuf[i] = (float)(v - shift);
    }
    fdwt(rev ? (void *)ibuf : (void *)fbuf, w, h, nl, rev, tmp, col);
    /* quantization and tier-1, code-block by code-block */
    for (int r = 0; r < t.nres && !rc; r++) {
        Res *R = &t.res[r];
        for (int pk = 0; pk < R->pw * R->ph && !rc; pk++)
            for (int bb = 0; bb < R->nb && !rc; bb++) {
                Band *B = &R->band[bb];
                PrecBand *pb = &R->prec[pk * R->nb + bb];
                int64_t ox = 0, oy = 0;
                if (r) {
                    Res *Rl = &t.res[r - 1];
                    if (B->orient & 1) ox = Rl->x1 - Rl->x0;
                    if (B->orient & 2) oy = Rl->y1 - Rl->y0;
                }
                /* the decoder's value is (q + 1/2) * 2 * B->step */
                double inv = rev ? 1.0 : 1.0 / (2.0 * B->step);
                for (int k = 0; k < pb->cw * pb->ch && !rc; k++) {
                    Cblk *c = &pb->cb[k];
                    int cw = (int)(c->x1 - c->x0), ch = (int)(c->y1 - c->y0);
                    for (int y = 0; y < ch; y++) {
                        size_t row = (size_t)(c->y0 - B->y0 + oy + y) * w
                                     + (size_t)(c->x0 - B->x0 + ox);
                        for (int x = 0; x < cw; x++) {
                            int64_t q;
                            if (rev) {
                                q = ibuf[row + x];
                            } else {
                                double v = (double)fbuf[row + x] * inv;
                                q = (int64_t)(v < 0 ? -floor(-v) : floor(v));
                            }
                            neg[y * cw + x] = q < 0;
                            uint64_t a = (uint64_t)(q < 0 ? -q : q);
                            mag[y * cw + x] = a > 0x7FFFFFFF ? 0x7FFFFFFF
                                                             : (uint32_t)a;
                        }
                    }
                    rc = encode_cblk(c, B, &t1, mag, neg, cw, ch, &mqbuf, &e);
                }
            }
    }
    /* tier-2: LRCP with one layer */
    for (int r = 0; r < t.nres && !rc; r++)
        for (int k = 0; k < t.res[r].pw * t.res[r].ph && !rc; k++)
            rc = write_packet(&t, r, k, &body, &e);
    if (rc) goto done;
    Buf cs = {0};
    put_codestream_header(&cs, &t.st, w, h, prec);
    put16(&cs, 0xFF90);                   /* SOT */
    put16(&cs, 10);
    put16(&cs, 0);
    put32(&cs, (uint32_t)(14 + body.n));
    put8(&cs, 0);
    put8(&cs, 1);
    put16(&cs, 0xFF93);                   /* SOD */
    putn(&cs, body.d, body.n);
    put16(&cs, 0xFFD9);                   /* EOC */
    if (cs.oom) {
        free(cs.d);
        rc = fail(&e, -4, "out of memory");
        goto done;
    }
    put_jp2_header(&o, w, h, prec, cs.n);
    putn(&o, cs.d, cs.n);
    free(cs.d);
    if (o.oom) {
        rc = fail(&e, -4, "out of memory");
        goto done;
    }
    *out = o.d;
    *outlen = o.n;
    o.d = NULL;
done:
    tile_free(&t);
    free(ibuf);
    free(fbuf);
    free(tmp);
    free(col);
    free(mag);
    free(neg);
    free(t1.t.f);
    free(mqbuf.d);
    free(body.d);
    free(o.d);
    return rc;
}

void j2k_free(void *p) { free(p); }
